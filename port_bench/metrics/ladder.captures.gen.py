"""Ladders the program captured as CUDA graphs during the window
(`LadderGraphs.captures` before and after each call): set-up warms every
shape the cell runs, so a capture here is work moved into the window."""


def read(reading):
    return reading["window"].get("captures")
