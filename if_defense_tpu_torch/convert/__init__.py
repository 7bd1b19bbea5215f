"""Converters from the reference's pretrained PyTorch weights to the flax
tree (port of `if_defense_tpu/convert`).

The reference distributes pretrained `.pth` files (PU-Net
`pu-in_1024-up_4.pth`, ONet `onet.pth`, ConvONet `convonet.pth`, victim
classifiers). Each converter gives the JAX package's flax-layout numpy
tree, leaf for leaf, so one converted file serves both packages:
`utils.params_io.save_params_npz` writes it for `--weights`,
`utils.checkpoint.save_eval_checkpoint` for a victim's `--checkpoint`, and
`utils.params_io.params_from_jax` loads it into a port module.
"""
