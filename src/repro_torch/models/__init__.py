"""Language-model substrate of the port: layers, the Mamba2 mixer and the
decoder assembly (only the attention-free ``ssm`` family so far)."""
