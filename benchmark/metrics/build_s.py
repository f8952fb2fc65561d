"""``build_s``: host clock around the port's ``build_opt_net`` (ending in
a synchronize), in s; the dataset before it is not counted."""


def read(run: dict):
    return run.get("build_s")
