"""PyTorch + CUDA port of tfhe_aes_tpu (TFHE AES-128 CTR), for NVIDIA Hopper.

The JAX package ``tfhe_aes_tpu`` is the reference this package is held
against, function by function, word for word.  This package never imports
jax.  From ``tfhe_aes_tpu`` it imports only the modules that are themselves
jax-free: ``params``, ``backend.numpy_backend``,
``utils.{crt,csprng,torus,noise_model}``, ``models.{tables,luts,aes_plain}``
and ``runtime``.

Entry point: ``python -m tfhe_aes_tpu_torch.cli`` (see ``cli.py``).

u64 torus words are carried as ``torch.int64`` (two's-complement wrap is
exact mod 2^64); see ``utils/torus.py``.
"""
