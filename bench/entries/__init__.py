"""What a cell's window drives: one module a traffic ``entry``.

Each entry module defines ``prepare(cfg, traffic, inputs, device)`` (the
program's objects for a fit, made in set-up), ``warm(state)``,
``run(state)`` (one timed fit, ended by a device sync, returning its
record), ``phases(rec)`` (the fit's host phases for the trace),
``stats(rec)`` (the per-fit numbers the per-layer readers take),
``extract(rec)`` (the fit's outputs as plain data), ``judge(inputs, out,
cfg, device)`` (the numbers compared against the plain reference),
``control(inputs, cfg, device)`` (the reference in the precision below the
configuration's, as plain outputs) and ``work(inputs, out, cfg)`` (the work
the fit needs).  A new entry is a new module here.
"""
