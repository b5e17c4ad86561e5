"""Frozen copies of the plain PyTorch versions of planet_tpu_torch's main
path, taken at the commit that added this benchmark: only the plain
functions that reference/lod.py and reference/field.py reach, with the
kernels' wrappers and launch branches left out, so everything here runs
as plain PyTorch on any device.

They are the yardstick, not the program: nothing here imports the port,
and a later change to the port's kernels or plain versions does not move
them. The modules keep the port's paths below this package (nums/df.py is
planet_tpu_torch/nums/df.py). The port's tests hold these plain versions
to planet_tpu, the JAX package; that is where their independence from
the kernels they check rests.
"""
