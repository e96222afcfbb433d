"""Set-up seconds: the Decoder's constructor to the end of the warm-up."""


def read(run):
    return run.setup_s
