"""Loop kinds, one file a kind, found by the `"loop"` of a traffic mix
(`spec.loop`).  Each defines `Loop`, a subclass of `kmerbench.loop.Loop`."""
