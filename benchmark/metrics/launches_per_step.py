"""The program's kernel launches (its ``LAUNCHES`` counters) in the window
over the optimizer steps taken."""


def read(ctx):
    steps = ctx["window"].get("steps", 0)
    if not steps:
        return None
    return sum(v for k, v in ctx["launches"].items() if k != "plain") / steps
