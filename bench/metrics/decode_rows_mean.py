"""decode_rows_mean: the mean number of live rows a decode step of the
window's untraced part computed (the requests the program advanced by one
token in it). Layer: the scheduler."""


def read(run):
    xs = [len(s.decode) for s in run.clean_steps() if s.decode]
    return sum(xs) / len(xs) if xs else None
