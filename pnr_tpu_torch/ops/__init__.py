"""Dense operators and the wrappers of the hand-written CUDA kernels (csrc/).

The JAX package's re-exports, resolved lazily (PEP 562) as there, so that
importing one submodule does not load the others.
"""

_EXPORTS = {
    "gaussian_kernel": "pnr_tpu_torch.ops.gaussian",
    "imgaussian2d": "pnr_tpu_torch.ops.gaussian",
    "imgaussian3d": "pnr_tpu_torch.ops.gaussian",
    "imgaussian_xy": "pnr_tpu_torch.ops.gaussian",
    "hessian2d": "pnr_tpu_torch.ops.hessian",
    "hessian3d": "pnr_tpu_torch.ops.hessian",
    "eigh3x3_vessel": "pnr_tpu_torch.ops.eig3",
    "frangi2d": "pnr_tpu_torch.ops.frangi",
    "frangi3d": "pnr_tpu_torch.ops.frangi",
    "normalize_to_u8": "pnr_tpu_torch.ops.frangi",
    "imdilate_xy": "pnr_tpu_torch.ops.morphology",
    "imerode_xy": "pnr_tpu_torch.ops.morphology",
    "imerode_xyz": "pnr_tpu_torch.ops.morphology",
    "histogram256": "pnr_tpu_torch.ops.thresholds",
    "intermodes_th": "pnr_tpu_torch.ops.thresholds",
    "maxentropy_th": "pnr_tpu_torch.ops.thresholds",
    "otsu_th": "pnr_tpu_torch.ops.thresholds",
    "trilinear": "pnr_tpu_torch.ops.interp",
    "ZnccTemplates": "pnr_tpu_torch.ops.zncc_model",
    "zncc_batch": "pnr_tpu_torch.ops.zncc",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(name)
