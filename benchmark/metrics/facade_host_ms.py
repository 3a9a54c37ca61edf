"""Mean host wall of one ``render()`` call of the facade in the window
(the benchmark's span around the call: the scene's invalidation, the
packing with its host reads, the launch, the accumulation)."""


def read(ctx):
    calls = ctx["spans"].get("render_call_s", [])
    return 1e3 * sum(calls) / len(calls) if calls else None
