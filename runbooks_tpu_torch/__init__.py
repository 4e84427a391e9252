"""PyTorch/CUDA port of the runbooks_tpu workload layer.

The package mirrors ``runbooks_tpu``'s module names so each counterpart is
easy to find, imports ``torch`` and never ``jax`` or ``runbooks_tpu``, and
replaces each Pallas TPU kernel on its path with a kernel written by hand
for Hopper (``csrc/``). Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; with no device given and no GPU present
they raise instead of falling back to the CPU.
"""
