"""Language-model substrate of the port: layers, attention (GQA/MQA, MLA),
the MoE FFN, the Mamba2 mixer and the decoder assembly of every family."""
