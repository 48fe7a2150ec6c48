"""Diffusion model: Unet3D, GaussianDiffusion, FlowDiffusion."""
