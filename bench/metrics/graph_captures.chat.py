"""graph_captures.chat: step graphs the program captured inside the window
(growth of its step families' ``_cache_size()``); every shape of the
traffic was warmed in set-up, so this should read 0. Layer: compiled
steps."""


def read(run):
    return run.captures
