"""Models of the port: the GAN generator on the Winograd DeConv engine."""
