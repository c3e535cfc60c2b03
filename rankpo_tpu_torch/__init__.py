"""rankpo_tpu_torch — the PyTorch/CUDA port of ``rankpo_tpu`` for NVIDIA Hopper.

The package mirrors ``rankpo_tpu``'s layout module for module. It imports
``torch`` and never ``jax``: nothing from ``rankpo_tpu`` is imported here,
because every ``rankpo_tpu`` import chain loads jax, so the few host-side
pieces the port needs are carried as copies. Subpackages import nothing
eagerly; import the module you need.
"""

__version__ = "0.1.0"
