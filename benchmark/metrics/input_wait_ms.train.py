"""Host ms per step in the harness's span around the prefetch
iterator's ``next``, over the window."""


def read(obs):
    return obs["window"]["host_ms"].get("input_wait") if "steps" in obs["window"] else None
