"""Models of the port: the decoder-only LM (dense, MoE), the SSM and hybrid
stacks, the encoder-decoder and the vision-language model (``api``)."""
