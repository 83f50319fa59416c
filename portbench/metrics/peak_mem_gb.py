"""``peak_mem_gb``: ``torch.cuda.max_memory_allocated()`` over the
window, reset at its start, in units of 1e9 bytes."""


def read(outcome: dict):
    return outcome["peak_bytes"] / 1e9 if outcome["peak_bytes"] else None
