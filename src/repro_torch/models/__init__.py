"""The LM stack (dense attention blocks): common blocks, attention, FFN
and the serving functions of `lm`."""
