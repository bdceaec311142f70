"""Set-up: process start to the window's start (imports, the snapshot on
the card, the Visualizer with its first EXPORT and colormap range, the
presort, kernel loads or builds, the warm-up steps), in s."""


def read(ctx):
    return ctx["setup_s"]
