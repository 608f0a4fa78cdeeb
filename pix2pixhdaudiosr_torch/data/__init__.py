"""Audio file I/O and the test dataset of the port: what the JAX package's
data/__init__.py exports, under the same names."""
from .wavio import read_wav, write_wav, wav_info  # noqa: F401
from .filelist import discover_files, train_val_split  # noqa: F401
from .dataset import AudioDataset, AudioTestDataset, Loader  # noqa: F401
