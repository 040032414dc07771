"""The research tier of the sample zoo (``python -m znicz_tpu_torch
research.<name>``), the counterpart of ``znicz_tpu/samples/research``.

Each module keeps the JAX module's contract: its config under
``root.<ns>``, ``build()``, ``run_sample()`` and the launcher's
``run(load, main)``.  ``research.alexnet``, ``research.mnist7`` and
``research.mnist_ae`` name the port's modules of the same name one
level up (``znicz_tpu_torch.launcher.FLAT_RESEARCH``).
"""
