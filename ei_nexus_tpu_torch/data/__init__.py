"""Dataset ingestion and event representations of the port. Counterpart
of `ei_nexus_tpu/data/`.

- `representations`: events -> the voxel grid on the device.
- `mvsec` / `ec`: MVSEC (HDF5) and Event-Camera (txt/npy/png) readers with
  the split, crop and pair protocols.
- `interpolator`: linear + slerp pose interpolation.
- `augment`: event, image and pair augmentations.
- `pipeline`: the sharded, threaded loader, collation and the put to the
  device.
- `synth`: synthetic bursty event streams.
- `rectify`: offline MVSEC rectification and EC undistortion.

h5py, yaml, cv2 and scipy are imported inside the functions that need
them, so importing this package needs none of them.
"""

from . import representations
from . import interpolator
from . import augment
from . import mvsec
from . import ec
from .pipeline import DataLoader, PinnedPut, collate, device_prefetch

__all__ = ["representations", "interpolator", "augment", "mvsec", "ec",
           "DataLoader", "PinnedPut", "collate", "device_prefetch"]
