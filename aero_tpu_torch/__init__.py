"""aero_tpu_torch — the AERO serving path in PyTorch, with CUDA kernels for Hopper.

A port of ``aero_tpu`` (JAX/Pallas on TPU), which stays the reference it is
tested against. Imports ``torch`` and never ``jax``.

- ``ops``    — STFT/iSTFT, LocalState attention (plain version and the CUDA
               kernel's wrapper), the nvcc build of ``csrc/``.
- ``models`` — the Aero generator, its building blocks, seeded init, factory.
- ``train``  — weight bridge from JAX variables and reference ``.th`` files.
- ``eval``   — full-file and chunked inference.
- ``predict``— the single-file inference CLI.
"""
