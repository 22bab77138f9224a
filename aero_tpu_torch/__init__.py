"""aero_tpu_torch — AERO serving and training in PyTorch, with CUDA kernels for Hopper.

A port of ``aero_tpu`` (JAX/Pallas on TPU), which stays the reference it is
tested against. Imports ``torch`` and never ``jax`` or ``aero_tpu``.

- ``ops``    — STFT/iSTFT, the mel spectrogram, the sinc resample of a
               tensor, LocalState attention (plain versions and the CUDA
               kernels' wrappers, forward and backward), the LSTM recurrence
               and FTB tail kernels, the nvcc build of ``csrc/``.
- ``models`` — the Aero and Seanet generators, Aero's building blocks, the
               MelGAN and HiFi-GAN (MPD, spectral-normed MSD)
               discriminators, seeded init, factory.
- ``losses`` — the multi-resolution STFT loss, the MelGAN losses and the
               HiFi-GAN LS-GAN and feature losses.
- ``train``  — the GAN train step, the Solver (epoch loop, validation,
               best states, evaluation schedule), checkpoints (the JAX
               package's ``.atpu`` in msgpack, reference ``.th`` through a
               restricted unpickler, Adam moments both ways), model
               building, the weight bridge from JAX variables, and the
               train CLI (``python -m aero_tpu_torch.train``).
- ``data``   — WAV I/O, the native reader, numpy resampling, the datasets
               (``LrHrSet``, ``PrHrSet``), the sharded ``Loader`` and
               dataset preparation.
- ``eval``   — full-file and chunked inference, LSD and ViSQOL, enhance
               and evaluate.
- ``utils``  — the config loader, logging, heatmap PNGs, the wandb shim,
               the host STFT.
- ``parallel`` — data parallelism over processes: the group from
               torchrun's variables, the cross-rank sums that make N
               ranks' step the one-process step on the global batch, the
               metric averages over ranks.
- ``test``, ``predict`` — the test-set and single-file CLIs.
- ``entry``  — the canonical forward and ``dryrun_multichip`` (one GAN
               step over gloo ranks on the CPU).
"""
