"""Hand-written CUDA kernels (``csrc/``), their wrappers, their plain
versions (``ref.py``) and the model-layout dispatch (``ops.py``).  Nothing
is built at import time."""
