"""Models of the port: the GAN generator on the Winograd DeConv engine, the
audio decoder, and the LM stack (``lm`` over ``attention``, ``mlp``, ``moe``,
``ssm``)."""
