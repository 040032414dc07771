"""Dataset loaders.

Counterpart of ``znicz_tpu/loader/__init__.py``: importing the package
registers the loaders named by a ``MAPPING`` string (JAX :17-22), the
LMDB, STL-10, ImageNet, pickles, interactive and minibatch-stream
loaders among them.  ``TEST``, ``VALID`` and ``TRAIN`` are 0, 1 and 2.
"""

from znicz_tpu_torch.loader.base import (  # noqa: F401
    CLASS_NAME, FullBatchLoader, FullBatchLoaderMSE, FullBatchLoaderMSEMixin,
    IFullBatchLoader, ILoader, Loader, LoaderMSEMixin, TEST, TRAIN,
    UserLoaderRegistry, VALID)
from znicz_tpu_torch.loader.image import (  # noqa: F401
    AutoLabelFileImageLoader, FileListImageLoader,
    FullBatchAutoLabelFileImageLoader, FullBatchFileListImageLoader,
    FullBatchImageLoader, IImageLoader, ImageLoaderBase)
# registration side effects (the loaders' MAPPING names)
import znicz_tpu_torch.loader.loader_lmdb  # noqa: F401
import znicz_tpu_torch.loader.loader_stl  # noqa: F401
import znicz_tpu_torch.loader.imagenet_loader  # noqa: F401
import znicz_tpu_torch.loader.pickles  # noqa: F401
import znicz_tpu_torch.loader.interactive  # noqa: F401
import znicz_tpu_torch.loader.saver  # noqa: F401
