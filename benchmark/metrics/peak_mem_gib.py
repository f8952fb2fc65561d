"""``peak_mem_gib``: ``torch.cuda.max_memory_allocated`` over the window,
in GiB."""


def read(run: dict):
    b = run.get("peak_window_bytes")
    return b / 2 ** 30 if b else None
