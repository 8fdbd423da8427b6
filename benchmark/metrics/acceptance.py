"""acceptance: accepted proposals over proposals in the window (the
chain step's int64 device counter step.counts['accepts'], summed at every
replay, read before and after the window). A guard: a faster step that
moves it is a different chain, not a gain."""


def read(ctx):
    return ctx['accepts'] / ctx['attempted']
