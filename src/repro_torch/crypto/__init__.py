"""Crypto of the port: ChaCha20, CW-MAC and the batched AEAD, on
int32-carried u32 words (see :mod:`repro_torch.u32`)."""
