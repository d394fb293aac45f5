"""Hand-written Hopper kernels (``csrc/``), their torch wrappers and plain
versions (``spm_stack.py``), the run planner and public entries
(``ops.py``), the build (``build.py``) and the plain oracle (``ref.py``).
Importing this package builds nothing and needs no CUDA."""
