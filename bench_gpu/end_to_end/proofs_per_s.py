"""Proofs whose accept bit was produced in the window, over the window's
seconds (from the start of the first verify call to the end of the last;
every call ends with a device synchronise)."""


def read(window):
    return window.units / window.seconds
