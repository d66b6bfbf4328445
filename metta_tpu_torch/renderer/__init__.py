"""Renderers of the port: the terminal ``miniscope``.

``metta_tpu/renderer/live_server.py`` (browser live play over a WebSocket
mettascope server) is not ported; what it defines is refused by name.
"""

LIVE_SERVER = "metta_tpu/renderer/live_server.py"
_UNPORTED = ("LivePlaySession", "make_server", "serve_play")


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(f"{name} ({LIVE_SERVER}) is not ported")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
