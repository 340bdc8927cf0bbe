"""Measurement harnesses of the port, run on the card:

    python -m rgbd_pose_estimation_tpu_torch.tools.roofline
    python -m rgbd_pose_estimation_tpu_torch.tools.msac_opt

Counterparts of the JAX repository's ``tools/roofline.py`` and
``tools/msac_opt.py``: the card's measured ceilings, the kernels against
them, the stage anatomy of the three paths, and the MSAC scorer's variants.
"""
