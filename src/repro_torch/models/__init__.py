"""The LM stack (attention blocks with dense or mixture-of-experts FFNs):
common blocks, attention, FFN and MoE, and `lm`'s init, quantized
forward and loss, prefill and decode."""
