"""Host-side native code of the port (counterpart of ``gwkit/native``)."""
from gwkit_torch.native.hostio import (  # noqa: F401
    available,
    extract_windows,
    f64_to_f32,
    read_contiguous_dataset,
)
