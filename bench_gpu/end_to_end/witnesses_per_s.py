"""Lanes whose whole witness trace was handed over in host memory in the
window, over the window's seconds (from the start of the stream to the
last hand-over)."""


def read(window):
    return window.units / window.seconds
