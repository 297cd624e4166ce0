"""The plain reference that decides ``correct``: plain PyTorch, float32,
importing nothing of the port. ``models/``, ``geometry/``, ``losses/`` and
``rendering/shading.py`` are frozen copies of the port's modules of the
same names (their docstrings name the lines of the JAX package each
follows), with the distributed paths taken out; ``ops/`` holds the plain
tile pass and a plain instance norm in place of the hand-written
kernels; ``rendering/renderer.py`` and ``steps.py`` rebuild the render,
the eval step and the train step from a configuration file's values."""
