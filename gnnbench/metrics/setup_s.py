"""Seconds from the start of the process to the window's first step:
imports, the card, the graph, the weights, the program's data build and
its first steps (which build or load the kernels)."""


def read(r):
    return r["setup_s"]
