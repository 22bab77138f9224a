"""aero_tpu_torch — AERO serving and training in PyTorch, with CUDA kernels for Hopper.

A port of ``aero_tpu`` (JAX/Pallas on TPU), which stays the reference it is
tested against. Imports ``torch`` and never ``jax`` or ``aero_tpu``.

- ``ops``    — STFT/iSTFT, LocalState attention (plain versions and the CUDA
               kernels' wrapper, forward and backward), the nvcc build of
               ``csrc/``.
- ``models`` — the Aero generator, its building blocks, the MelGAN
               discriminator, seeded init, factory.
- ``losses`` — the multi-resolution STFT loss and the MelGAN losses.
- ``train``  — the GAN train step, model building, and the weight bridge
               from JAX variables and reference ``.th`` files.
- ``eval``   — full-file and chunked inference.
- ``data``, ``utils`` — WAV I/O and the config loader (own copies).
- ``predict``— the single-file inference CLI.
"""
