"""Offline ETL: COCO annotation JSON → image-grouped Parquet (the port's
own copy of ``custom_yolo_tpu/data/preprocess.py``).

It writes the same Parquet as the JAX package's ETL: the same columns, the
same pyarrow schema (:func:`parquet_schema`, also as ``PARQUET_SCHEMA``),
snappy compression and ``{folder}-{i}.parquet`` names, so a dataset
prepared by either package is read by both. The JSON is streamed through
an incremental ``raw_decode`` cursor (the 1 GB COCO train file is never
resident); annotation rows are routed per image into hash shards spilled
to disk and grouped shard by shard, so peak memory is one shard plus the
image and category lookup tables. RLE segmentations become polygons
through :mod:`coco_rle` and ``cv2`` contours.

Semantics: categories are deduplicated, sorted by name, and the position
becomes the training category id; ``is_test`` stops each stream after item
500; crowd segmentations are stored as empty polygon lists (their RLE
counts do not fit the float-polygon schema, and detection never reads
them); rows are images ⋈ annotations ⋈ categories grouped per image.
``pandas`` and ``pyarrow`` are imported inside the functions that use
them, so importing the package stays light.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, Iterator, List, Optional

from custom_yolo_tpu_torch.data.coco_rle import rle_to_polygons

# flat-row column order used while streaming annotations (pre-grouping)
_ROW_FIELDS = ("file_name", "height", "width", "id", "segmentation", "area",
               "iscrowd", "bbox", "category_id", "supercategory",
               "old_category_id", "name")


def parquet_schema():
    """The pyarrow schema of the grouped Parquet."""
    import pyarrow as pa

    return pa.schema([
        ("file_name", pa.string()),
        ("height", pa.int64()),
        ("width", pa.int64()),
        ("id", pa.int64()),
        ("segmentation", pa.list_(pa.list_(pa.list_(pa.float64())))),
        ("area", pa.list_(pa.float64())),
        ("iscrowd", pa.list_(pa.int64())),
        ("bbox", pa.list_(pa.list_(pa.float64()))),
        ("category_id", pa.list_(pa.int64())),
        ("supercategory", pa.list_(pa.string())),
        ("old_category_id", pa.list_(pa.int64())),
        ("name", pa.list_(pa.string())),
    ])


def __getattr__(name: str):
    # PARQUET_SCHEMA, built when first asked for (pyarrow loads then)
    if name == "PARQUET_SCHEMA":
        return parquet_schema()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def stream_json_items(path: str, key: str,
                      is_test: bool = False,
                      test_limit: int = 500,
                      buf_size: int = 1 << 22) -> Iterator[Dict[str, Any]]:
    """Yield items of the top-level array ``key`` from a (possibly huge)
    JSON file without holding the document in memory: read in ``buf_size``
    chunks, locate ``"key": [``, then ``raw_decode`` one element at a time
    from a sliding buffer whose consumed prefix is discarded."""
    decoder = json.JSONDecoder()
    probe = f'"{key}"'
    with open(path, "r") as f:
        buf = f.read(buf_size)
        # 1. locate the probe (keep a probe-sized overlap across chunks)
        while True:
            i = buf.find(probe)
            if i >= 0:
                buf = buf[i + len(probe):]
                break
            more = f.read(buf_size)
            if not more:
                return
            buf = buf[-(len(probe) - 1):] + more if len(buf) >= len(probe) \
                else buf + more
        # 2. locate the opening bracket of the array
        while True:
            j = buf.find("[")
            if j >= 0:
                buf = buf[j + 1:]
                break
            more = f.read(buf_size)
            if not more:
                return
            buf = more
        # 3. decode elements one by one
        pos = 0
        count = 0
        while True:
            # skip separators, refilling at buffer end
            while True:
                while pos < len(buf) and buf[pos] in " \t\r\n,":
                    pos += 1
                if pos < len(buf):
                    break
                more = f.read(buf_size)
                if not more:
                    return
                buf, pos = more, 0
            if buf[pos] == "]":
                return
            while True:
                try:
                    obj, new_pos = decoder.raw_decode(buf, pos)
                    break
                except json.JSONDecodeError:
                    more = f.read(buf_size)
                    if not more:
                        raise  # truncated document
                    buf, pos = buf[pos:] + more, 0
            pos = new_pos
            if pos > buf_size:  # discard consumed prefix
                buf, pos = buf[pos:], 0
            yield obj
            count += 1
            if is_test and count > test_limit:
                return


class _ShardSpill:
    """Annotation rows routed per image into N on-disk pickle shards, so
    grouping never needs the whole dataset in memory. One shard keeps its
    rows in a list."""

    def __init__(self, tmp_dir: str, n_shards: int,
                 flush_rows: int = 8_000):
        self.n = max(1, n_shards)
        self.tmp_dir = tmp_dir
        self.flush_rows = flush_rows
        self._mem: List[tuple] = []       # single-shard fast path
        self._buffers: List[List[tuple]] = [[] for _ in range(self.n)]
        self._files = []
        if self.n > 1:
            os.makedirs(tmp_dir, exist_ok=True)
            self._files = [open(os.path.join(tmp_dir, f"shard-{i}.pkl"),
                                "wb") for i in range(self.n)]

    def add(self, image_id: int, row: tuple) -> None:
        if self.n == 1:
            self._mem.append(row)
            return
        s = image_id % self.n
        buf = self._buffers[s]
        buf.append(row)
        if len(buf) >= self.flush_rows:
            pickle.dump(buf, self._files[s],
                        protocol=pickle.HIGHEST_PROTOCOL)
            self._buffers[s] = []

    def shards(self) -> Iterator[List[tuple]]:
        if self.n == 1:
            yield self._mem
            return
        for i, fh in enumerate(self._files):
            if self._buffers[i]:
                pickle.dump(self._buffers[i], fh,
                            protocol=pickle.HIGHEST_PROTOCOL)
                self._buffers[i] = []
            fh.close()
        for i in range(self.n):
            path = os.path.join(self.tmp_dir, f"shard-{i}.pkl")
            rows: List[tuple] = []
            with open(path, "rb") as fh:
                while True:
                    try:
                        rows.extend(pickle.load(fh))
                    except EOFError:
                        break
            yield rows
            os.remove(path)


class DataPreprocess:
    """COCO JSON → Parquet, with the JAX package's constructor and static
    entry points."""

    def __init__(self, annotations_dir: str, output_dir: str,
                 is_test: bool = False):
        self.input_dir = annotations_dir
        self.output_dir = output_dir
        self.is_test = is_test

    def load_annotations_file(self, file_names: List[str], key: str,
                              columns: Optional[List[str]] = None,
                              chunk_size: int = 10_000):
        """Stream ``key`` items from each file into one DataFrame, then per
        key: images deduplicated; categories deduplicated, sorted by name
        and given their position as ``index``."""
        import pandas as pd

        chunks: List[pd.DataFrame] = []
        for file in file_names:
            current: List[Dict[str, Any]] = []
            for obj in stream_json_items(os.path.join(self.input_dir, file),
                                         key, is_test=self.is_test):
                current.append(obj)
                if len(current) >= chunk_size:
                    chunks.append(pd.DataFrame(current, columns=columns))
                    current = []
            if current:
                chunks.append(pd.DataFrame(current, columns=columns))
        if not chunks:
            return pd.DataFrame(columns=columns)
        df = pd.concat(chunks, ignore_index=True)
        if key == "images":
            return df.drop_duplicates()
        if key == "categories":
            return (df.drop_duplicates()
                      .sort_values(by=["name"], ignore_index=True)
                      .reset_index())
        return df

    def _polygons_row(self, seg, iscrowd):
        if isinstance(seg, dict) and "counts" in seg:
            if iscrowd == 1:
                # crowd RLE counts break the float-polygon parquet schema;
                # stored as an empty polygon list (never consumed)
                return []
            return rle_to_polygons(seg)
        return seg

    @staticmethod
    def create_parquet_data(annotations_dir: str, output_dir: str,
                            output_folder: str, file_names: List[str],
                            keys: List[str], columns: List[List[str]],
                            chunk_sizes: List[int], is_test: bool,
                            images_per_shard: int = 40_000) -> None:
        """Write ``output_dir/output_folder/{output_folder}-{i}.parquet``,
        one file per ``images_per_shard`` images; peak memory is bounded by
        one shard. ``keys`` name the images, annotations and categories
        arrays, with their ``columns`` and ``chunk_sizes``."""
        import pandas as pd
        import pyarrow as pa
        import pyarrow.parquet as pq

        pp = DataPreprocess(annotations_dir, output_dir, is_test=is_test)
        images = pp.load_annotations_file(file_names, keys[0], columns[0],
                                          chunk_sizes[0])
        categos = pp.load_annotations_file(file_names, keys[2], columns[2],
                                           chunk_sizes[2])

        # lookup tables (inner-join semantics: unknown ids are skipped)
        img_lut = {int(r.id): (r.file_name, int(r.height), int(r.width))
                   for r in images.itertuples()}
        cat_lut = {int(r.id): (int(r.index), r.name, r.supercategory)
                   for r in categos.itertuples()}
        del images, categos

        path = os.path.join(output_dir, output_folder)
        os.makedirs(path, exist_ok=True)
        n_shards = max(1, -(-len(img_lut) // images_per_shard))
        spill = _ShardSpill(os.path.join(path, "_spill"), n_shards)

        for file in file_names:
            for ann in stream_json_items(
                    os.path.join(annotations_dir, file), keys[1],
                    is_test=is_test):
                img = img_lut.get(ann.get("image_id"))
                cat = cat_lut.get(ann.get("category_id"))
                if img is None or cat is None:
                    continue
                iscrowd = ann.get("iscrowd")
                seg = pp._polygons_row(ann.get("segmentation"), iscrowd)
                if iscrowd == 1:
                    seg = []
                new_cat, name, supercat = cat
                row = (img[0], img[1], img[2], int(ann["image_id"]),
                       seg, ann.get("area"), iscrowd, ann.get("bbox"),
                       new_cat, supercat, int(ann["category_id"]), name)
                spill.add(int(ann["image_id"]), row)

        schema = parquet_schema()
        agg = {"segmentation": list, "area": list, "iscrowd": list,
               "bbox": list, "category_id": list, "supercategory": list,
               "old_category_id": list, "name": list}
        for i, rows in enumerate(spill.shards()):
            flat = pd.DataFrame(rows, columns=_ROW_FIELDS)
            grouped = (flat.groupby(by=["file_name", "height", "width",
                                        "id"]).agg(agg).reset_index())
            # one thread: each converting thread grows a heap of arrow's
            # allocator that stays resident (~30 MB of RSS at 25k rows)
            table = pa.Table.from_pandas(grouped[schema.names],
                                         schema=schema,
                                         preserve_index=False, nthreads=1)
            pq.write_table(table, os.path.join(
                path, f"{output_folder}-{i}.parquet"), compression="snappy")
            # let this shard go before the next one is read: the peak is
            # one shard, not two
            del rows, flat, grouped, table
        spill_dir = os.path.join(path, "_spill")
        if os.path.isdir(spill_dir) and not os.listdir(spill_dir):
            os.rmdir(spill_dir)

    @staticmethod
    def category_mapping(annotations_dir: str, file_names: List[str]):
        """Training-id ↔ COCO-id/name table (sorted-by-name reindex)."""
        pp = DataPreprocess(annotations_dir, ".", is_test=False)
        cats = pp.load_annotations_file(file_names, "categories")
        return cats.rename(columns={"index": "category_id",
                                    "id": "coco_id"})
