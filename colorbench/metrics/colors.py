"""colors: the mean count of distinct colors in the final colorings of the
window's first solves (their keys are fixed by the seed), counted by the
benchmark from the views."""


def read(run):
    if not run.colors:
        return None
    return sum(run.colors) / len(run.colors)
