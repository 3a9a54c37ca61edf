"""Differentiable rendering: gradients of images with respect to the scene.

``gradients`` holds the parameter plumbing, the autograd render through the
plain versions and ``InverseRenderer``; ``cuda_diff`` the render whose
forward is K1 and whose backward is K2.
"""
