"""Stage 1's models: FaceBoxes, the 3DDFA 3DMM regressors and the BFM.

Port of ``dawn_tpu/models/face3d``: the two CNNs (and the 3DDFA zoo's
alternate regressors) as ``nn.Module``s in the reference checkpoints'
state_dict layouts, NCHW; the anchors, NMS, BFM reconstruction and pose math
as copies of the JAX package's host numpy code.
"""
