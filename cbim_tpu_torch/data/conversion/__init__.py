"""Offline dataset conversion (counterpart of ``cbim_tpu/data/conversion``):
the host-side resampling helpers, which the prediction CLI uses too, and
``convert`` (``python -m cbim_tpu_torch.data.conversion.convert``)."""

from .utils import (CropForeground, reorient_to_ras, resample_label_to_shape,
                    resample_to_shape, resample_to_spacing)

__all__ = ["resample_to_spacing", "resample_to_shape",
           "resample_label_to_shape", "reorient_to_ras", "CropForeground"]
