"""Seconds from the process's start to the window's first message: the
stream's making, the program's construction, its first (compiling) calls
and the warm-up on the stream (host clock)."""


def read(ctx):
    return ctx.result["setup_s"]
