"""repro_torch.objstore — content-addressed object-store L4: an S3-shaped
client abstraction, chunk-level dedup uploads, a CAS-guarded checkpoint
catalog, crash-safe retention GC, and the ``ObjectStoreTier`` that
composes them into the checkpoint pipeline's level-4 stack."""
from repro_torch.objstore.catalog import Catalog, CatalogConflictError
from repro_torch.objstore.cdc import CDCParams, Chunker
from repro_torch.objstore.chunks import (
    ChunkCache,
    ChunkStream,
    ChunkUploader,
    FileEntry,
    chunk_key,
    fetch_file_delta,
)
from repro_torch.objstore.client import (
    LocalFSObjectStore,
    MemoryObjectStore,
    ObjectStore,
    ObjectStoreError,
    PreconditionFailed,
    make_object_store,
)
from repro_torch.objstore.gc import collect, retention_split
from repro_torch.objstore.inspect import (
    CatalogView,
    ChunkDelta,
    EntryInfo,
    FileInfo,
)
from repro_torch.objstore.subscriber import CatalogSubscriber, DeploySelector

__all__ = [
    "CDCParams", "Catalog", "CatalogConflictError", "CatalogSubscriber",
    "CatalogView", "ChunkCache", "ChunkDelta", "ChunkStream",
    "ChunkUploader", "Chunker", "DeploySelector", "EntryInfo", "FileEntry",
    "FileInfo", "LocalFSObjectStore", "MemoryObjectStore", "ObjectStore",
    "ObjectStoreError", "PreconditionFailed", "chunk_key", "collect",
    "fetch_file_delta", "make_object_store", "retention_split",
]
