"""PyTorch + CUDA port of tfhe_aes_tpu (TFHE AES-128 CTR), for NVIDIA Hopper.

The JAX package ``tfhe_aes_tpu`` is the reference this package is held
against, function by function, word for word.  This package imports
nothing of ``tfhe_aes_tpu`` and never imports jax: the host modules it
shares with the reference (``params``, ``backend.numpy_backend``,
``utils.{crt,csprng,host_torus,noise_model}``,
``models.{tables,luts,aes_plain}`` and ``runtime``) are copies, held
against their originals by ``tests/test_torch_host_copies.py``.  Its entry
points run on the card unless the caller asks for the CPU.

Entry point: ``python -m tfhe_aes_tpu_torch.cli`` (see ``cli.py``).

u64 torus words are carried as ``torch.int64`` (two's-complement wrap is
exact mod 2^64); see ``utils/torus.py``.
"""
