"""Seconds from the process's start to the window's first operation: the
imports, the device, the kernels' load (their build in a checkout's first
run), drawing the corpus, the set-up's build and the warm unit."""


def read(ctx):
    return ctx.window["setup_s"]
