"""``batch_ms``: host clock around ``dataset.get_batch``, the mean over the
window's steps, in ms."""


def read(run: dict):
    rows = run.get("batch_ms") or []
    return sum(rows) / len(rows) if rows else None
