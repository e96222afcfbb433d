"""Audio seconds of the batches the window completed over its seconds."""


def read(run):
    w = run.window
    if w.seconds <= 0:
        return None
    return w.audio_s / w.seconds
