"""Version diffing (Longtail_CreateVersionDiff src/longtail.c:7493,
Longtail_GetRequiredChunkHashes :4349).

Assets match by path hash; content changes by content hash (hash of the
asset's chunk-hash sequence); permission changes tracked separately.
Removed assets sort long-to-short path so children delete before parents
(:7750); added assets sort short-to-long so parents create before children
(:7751).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from longtail_tpu_torch.formats.version_index import VersionIndex


@dataclasses.dataclass
class VersionDiff:
    source_removed_asset_indexes: np.ndarray       # into source vi
    target_added_asset_indexes: np.ndarray         # into target vi
    source_content_modified_asset_indexes: np.ndarray
    target_content_modified_asset_indexes: np.ndarray
    source_permissions_modified_asset_indexes: np.ndarray
    target_permissions_modified_asset_indexes: np.ndarray

    @property
    def any_changes(self) -> bool:
        return bool(len(self.source_removed_asset_indexes)
                    or len(self.target_added_asset_indexes)
                    or len(self.source_content_modified_asset_indexes)
                    or len(self.source_permissions_modified_asset_indexes))


def create_version_diff(source: VersionIndex,
                        target: VersionIndex) -> VersionDiff:
    s_hashes = np.asarray(source.path_hashes, dtype=np.uint64)
    t_hashes = np.asarray(target.path_hashes, dtype=np.uint64)

    s_in_t = np.isin(s_hashes, t_hashes)
    t_in_s = np.isin(t_hashes, s_hashes)

    removed = np.flatnonzero(~s_in_t)
    added = np.flatnonzero(~t_in_s)

    # align matched assets
    s_matched = np.flatnonzero(s_in_t)
    t_order = np.argsort(t_hashes, kind="stable")
    t_pos = t_order[np.searchsorted(t_hashes[t_order], s_hashes[s_matched])]

    content_differs = source.content_hashes[s_matched] != \
        target.content_hashes[t_pos]
    perms_differ = (~content_differs) & (
        source.permissions[s_matched] != target.permissions[t_pos])

    src_modified = s_matched[content_differs]
    tgt_modified = t_pos[content_differs]
    src_perm = s_matched[perms_differ]
    tgt_perm = t_pos[perms_differ]

    # delete children before parents; create parents before children
    removed = np.asarray(
        sorted(removed.tolist(),
               key=lambda i: (-len(source.path(i)), i)), dtype=np.uint32)
    added = np.asarray(
        sorted(added.tolist(),
               key=lambda i: (len(target.path(i)), i)), dtype=np.uint32)

    return VersionDiff(
        source_removed_asset_indexes=removed,
        target_added_asset_indexes=added,
        source_content_modified_asset_indexes=src_modified.astype(np.uint32),
        target_content_modified_asset_indexes=tgt_modified.astype(np.uint32),
        source_permissions_modified_asset_indexes=src_perm.astype(np.uint32),
        target_permissions_modified_asset_indexes=tgt_perm.astype(np.uint32),
    )


def get_required_chunk_hashes(version_index: VersionIndex,
                              diff: VersionDiff) -> np.ndarray:
    """Unique chunk hashes needed to materialize added + content-modified
    assets (Longtail_GetRequiredChunkHashes src/longtail.c:4349); first-seen
    order preserved."""
    assets = np.concatenate([
        np.asarray(diff.target_added_asset_indexes, dtype=np.int64),
        np.asarray(diff.target_content_modified_asset_indexes,
                   dtype=np.int64)])
    _, flat_ci, _ = version_index.flat_chunk_walk(assets)
    hashes = version_index.chunk_hashes[flat_ci]
    uh, first = np.unique(hashes, return_index=True)
    return hashes[np.sort(first)]  # unique, first-seen order preserved
