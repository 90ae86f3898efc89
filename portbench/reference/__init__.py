"""The benchmark's plain reference: what the filter computes, in plain
PyTorch, from the option string alone.

A frozen copy of the port's plain path (option parsing and output
geometry, warp maps, the adaptive prefilter, the remap with every
interpolator and border rule, INTER_AREA supersampling, 8- to 16-bit
samples), kept under the benchmark's own paths so that a later change to
the program cannot move the yardstick.  It imports neither jax, nor
``transform360_tpu``, nor anything of ``transform360_tpu_torch``, and
takes nothing the program has made: it builds its own plan from the
cell's options and input size (:func:`.plan.open_plan`) and transforms
the same input planes the program was given (:func:`.plan.transform`).
"""
