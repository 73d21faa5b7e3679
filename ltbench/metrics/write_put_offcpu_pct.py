"""Block writing: share (%) of the ``write.put`` spans' wall that their
threads spent off the CPU (wall less the thread's CPU time): the
interpreter lock, other locks, I/O.  A CUDA event's wait spins by
default, so it counts as CPU."""

from ltbench import program_spans


def read(ctx):
    spans = program_spans.window(ctx)
    if spans is None:
        return None
    puts = [s for s in spans if s.name == "write.put"]
    wall = sum(s.t1_ns - s.t0_ns for s in puts)
    if not wall:
        return None
    return 100.0 * sum(s.t1_ns - s.t0_ns - s.cpu_ns for s in puts) / wall
