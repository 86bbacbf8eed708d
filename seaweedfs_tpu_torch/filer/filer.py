"""Filer core: the namespace layer.

Behavioral match of weed/filer2/filer.go: path→Entry CRUD over a
pluggable store with

  * parent-directory auto-creation on CreateEntry (filer.go:76
    ensures every ancestor exists, cached),
  * overwrite semantics that hand replaced chunks to an async deletion
    channel (filer_deletion.go:11-66 loopProcessingDeletion),
  * recursive delete collecting every descendant's chunks
    (filer_delete_entry.go:11),
  * update-event notifications for the replication plane
    (filer_notify.go:9-39).

The port of seaweedfs_tpu/filer/filer.py; stop() also joins the
deletion loop's thread.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from seaweedfs_tpu_torch.filer import filechunks
from seaweedfs_tpu_torch.filer.entry import (
    Attr,
    Entry,
    new_directory_entry,
    normalize_path,
    split_path,
)
from seaweedfs_tpu_torch.filer.filerstore import EntryNotFound, FilerStore


class Filer:
    def __init__(
        self,
        store: FilerStore,
        masters: list[str] | None = None,
        on_event: Callable[[Entry | None, Entry | None, bool], None] | None = None,
    ):
        self.store = store
        self.masters = masters or []
        # (old_entry, new_entry, delete_chunks) — the EventNotification
        # triple pushed to notification queues (filer_notify.go)
        self.on_event = on_event
        self._dir_cache: set[str] = set()  # ccache role (filer.go:33)
        self._deletion_lock = threading.Lock()
        # held across a flush's sends, so a flush returns only once every
        # deletion queued before it was sent, the deletion loop's in-flight
        # batch included
        self._flush_lock = threading.Lock()
        self._pending_chunk_deletions: list[str] = []
        self._deletion_thread: threading.Thread | None = None
        self._stop = threading.Event()

    # ------------------------------------------------------------------
    # deletion channel (filer_deletion.go)
    def start_deletion_loop(self, interval: float = 1.0) -> None:
        def loop():
            while not self._stop.wait(interval):
                self.flush_chunk_deletions()

        self._deletion_thread = threading.Thread(target=loop, daemon=True)
        self._deletion_thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._deletion_thread is not None:
            self._deletion_thread.join(timeout=30)
            self._deletion_thread = None
        self.flush_chunk_deletions()
        self.store.close()

    def delete_chunks_async(self, fids: list[str]) -> None:
        with self._deletion_lock:
            self._pending_chunk_deletions.extend(fids)

    def flush_chunk_deletions(self) -> None:
        with self._flush_lock:
            with self._deletion_lock:
                fids, self._pending_chunk_deletions = self._pending_chunk_deletions, []
            if not fids or not self.masters:
                return
            from seaweedfs_tpu_torch.client import operation as op

            try:
                # HA: any live master can resolve locations for the batch
                op.with_master_failover(
                    self.masters, lambda m: op.delete_files(m, fids)
                )
            except Exception:  # noqa: BLE001 — deletion is best-effort GC
                pass

    # ------------------------------------------------------------------
    def _notify(self, old: Entry | None, new: Entry | None, delete_chunks: bool) -> None:
        if self.on_event:
            self.on_event(old, new, delete_chunks)

    def create_entry(self, entry: Entry) -> None:
        """Insert (or overwrite) an entry, auto-creating parents
        (filer.go:76 CreateEntry)."""
        dir_path = entry.directory
        self._ensure_dirs(dir_path)
        old = None
        try:
            old = self.store.find_entry(entry.full_path)
        except EntryNotFound:
            pass
        if old is not None and not old.is_directory and not entry.is_directory:
            # replaced chunks → deletion channel (deleteChunksIfNotNew)
            old_garbage = filechunks.minus_chunks(old.chunks, entry.chunks)
            if old_garbage:
                self.delete_chunks_async([c.fid for c in old_garbage])
        self.store.insert_entry(entry)
        self._notify(old, entry, delete_chunks=old is not None)

    def _ensure_dirs(self, dir_path: str) -> None:
        dir_path = normalize_path(dir_path)
        if dir_path == "/" or dir_path in self._dir_cache:
            return
        parent, _ = split_path(dir_path)
        self._ensure_dirs(parent)
        try:
            existing = self.store.find_entry(dir_path)
            if existing.is_directory:
                # weedlint: ignore[race-check-then-act] — idempotent cache fill: concurrent mkdirs both insert the same directory entry (store is last-writer-wins) and both add the same path; holding _lock across store I/O would serialize every write
                self._dir_cache.add(dir_path)
                return
        except EntryNotFound:
            pass
        d = new_directory_entry(dir_path)
        self.store.insert_entry(d)
        # weedlint: ignore[race-check-then-act] — idempotent cache fill: duplicate insert_entry of a fresh directory is last-writer-wins on identical bytes; set.add is atomic and the worst case is one redundant notify
        self._dir_cache.add(dir_path)
        self._notify(None, d, delete_chunks=False)

    def find_entry(self, full_path: str) -> Entry:
        full_path = normalize_path(full_path)
        if full_path == "/":
            return new_directory_entry("/")
        return self.store.find_entry(full_path)

    def update_entry(self, entry: Entry) -> None:
        old = None
        try:
            old = self.store.find_entry(entry.full_path)
        except EntryNotFound:
            pass
        self.store.update_entry(entry)
        self._notify(old, entry, delete_chunks=False)

    def list_entries(
        self,
        dir_path: str,
        start_file_name: str = "",
        include_start: bool = False,
        limit: int = 1024,
        prefix: str = "",
    ) -> list[Entry]:
        entries = self.store.list_directory_entries(
            dir_path, start_file_name, include_start, limit
        )
        if prefix:
            entries = [e for e in entries if e.name.startswith(prefix)]
        return entries

    def delete_entry(
        self,
        full_path: str,
        is_recursive: bool = False,
        delete_data: bool = True,
    ) -> list[str]:
        """Delete an entry; directories require is_recursive when
        non-empty. Returns the chunk fids queued for deletion
        (filer_delete_entry.go DeleteEntryMetaAndData)."""
        entry = self.find_entry(full_path)
        fids: list[str] = []
        if entry.is_directory:
            children = self.store.list_directory_entries(full_path, "", True, 2)
            if children and not is_recursive:
                raise ValueError(f"{full_path}: folder not empty")
            self._collect_and_delete_children(full_path, fids)
        else:
            fids.extend(c.fid for c in entry.chunks)
        self.store.delete_entry(full_path)
        self._dir_cache.discard(normalize_path(full_path))
        if delete_data and fids:
            self.delete_chunks_async(fids)
        self._notify(entry, None, delete_chunks=delete_data)
        return fids

    def _collect_and_delete_children(self, dir_path: str, fids: list[str]) -> None:
        while True:
            children = self.store.list_directory_entries(dir_path, "", True, 1024)
            if not children:
                return
            for child in children:
                if child.is_directory:
                    self._collect_and_delete_children(child.full_path, fids)
                else:
                    fids.extend(c.fid for c in child.chunks)
                self.store.delete_entry(child.full_path)
                self._dir_cache.discard(normalize_path(child.full_path))

    # ------------------------------------------------------------------
    def atomic_rename(self, old_path: str, new_path: str) -> None:
        """Move an entry (recursively for directories) inside one store
        transaction (filer_grpc_server_rename.go AtomicRenameEntry)."""
        self.store.begin_transaction()
        try:
            self._rename_recursive(normalize_path(old_path), normalize_path(new_path))
            self.store.commit_transaction()
        except BaseException:
            self.store.rollback_transaction()
            raise

    def _rename_recursive(self, old_path: str, new_path: str) -> None:
        entry = self.store.find_entry(old_path)
        if entry.is_directory:
            self._ensure_dirs(new_path)
            for child in self.store.list_directory_entries(old_path, "", True, 1 << 30):
                self._rename_recursive(
                    child.full_path, f"{new_path}/{child.name}"
                )
            self.store.delete_entry(old_path)
            self._dir_cache.discard(old_path)
        else:
            moved = Entry(
                full_path=new_path,
                attr=entry.attr,
                chunks=list(entry.chunks),
                extended=dict(entry.extended),
            )
            self._ensure_dirs(moved.directory)
            self.store.insert_entry(moved)
            self.store.delete_entry(old_path)
        self._notify(entry, None, delete_chunks=False)
