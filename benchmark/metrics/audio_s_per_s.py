"""audio_s_per_s: seconds of audio of every request completed in the window,
over the window's wall seconds (host clock)."""


def read(run):
    w = run.window
    return w["audio_s"] / w["seconds"] if "audio_s" in w else None
