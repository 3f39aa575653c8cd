"""Host ms per batch inside the harness's span around assembly, H2D
and the step call, over the window."""


def read(obs):
    return obs["window"]["host_ms"].get("dispatch") if "tiles" in obs["window"] else None
