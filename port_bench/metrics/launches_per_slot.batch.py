"""launches_per_slot.batch: kernel launches per slot (launch records of the runtime and driver): a
count that repeats exactly for a seed."""


def read(t, ctx):
    return t.launches / (t.calls * ctx["units_per_call"]) if t.calls else None
