"""Explainability (port of ``vipers/explain``): GradCAM, Guided-GradCAM,
Integrated Gradients with SmoothGrad, epsilon-LRP, ViT attention maps, and
their RMA/RRA scores against segmentation masks."""
