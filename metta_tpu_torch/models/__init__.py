"""Policies of the port: the ViT policy and its building blocks, as nn.Modules."""
