"""A configuration's inputs: one module a generator, found by the name in
the configuration's ``dataset["generator"]``.

Each module defines ``make(dataset, seed)``: the arrays that the
configuration's entries take, from its ``dataset`` and the run seed, made
alike for the program and for the reference.  A new kind of input is a new
module here.
"""
