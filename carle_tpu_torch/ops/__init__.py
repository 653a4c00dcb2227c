"""CA, packed-CA and wrapper-net operations: plain PyTorch versions
(``ca``, ``bitpack``) and the CUDA kernel wrappers that hold their plain
twins (``cuda_ca``, ``cuda_bitpack``, ``cuda_head``)."""
