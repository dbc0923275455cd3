"""Branchy DeepLabV3 and its ResNet trunk and ASPP heads (PyTorch)."""
