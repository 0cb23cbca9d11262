"""The LM scaffold's serving path: layers, SSD blocks, the dense and ssm
families, and the conversion of the JAX reference's parameters."""
