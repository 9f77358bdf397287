"""Seconds of audio (padding left out) that the train steps done in the
window consumed, over the window's seconds, which end in a synchronise."""


def read(run):
    if run.window_s <= 0:
        return None
    return run.audio_s / run.window_s
