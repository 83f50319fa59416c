"""``setup_s``: seconds from the start of the process to the first timed
request: imports, the pool made on the card and copied to the host,
the engine, the kernels loaded (built on a checkout's first run) and one
warm-up answer."""


def read(outcome: dict):
    return outcome["setup_s"]
