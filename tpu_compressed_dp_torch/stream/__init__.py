"""Delta-compressed state streaming: incremental checkpoints, warm rejoin,
and a model-push channel over the compressed wire.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.stream`, segment files
byte layout for byte layout (either package reads the other's stream).
``stream/`` reuses the wire compressor
(:func:`tpu_compressed_dp_torch.ops.wire.select_pack_topk`, on the card the
threshold search's count kernels and the fused select+pack) on **parameter
deltas**: each window emits Top-K of ``params - last_streamed`` with an
EF-style residual ("Sparsified SGD with Memory", arxiv 1809.07599), a
window-closing flush makes the stream lossless (``keyframe + sum(deltas) ==
params`` *bitwise* in fp32), and periodic full keyframes bound recovery
depth.  Every segment is manifest-checksummed like the checkpoints, so
corruption is detectable offline (:func:`verify_stream`) and at apply time.

Three consumers ride the same segment stream:

  * **incremental checkpoints**: :class:`StreamWriter` appends segments
    continuously (codec on the caller's thread and device, commit in the
    background, like the Checkpointer's writer);
  * **warm rejoin**: a joiner at the rendezvous barrier adopts the
    parameters from the stream (:func:`warm_rejoin`) instead of the
    survivors' broadcast, and the coordinator's barrier flush
    (:meth:`StreamWriter.sync`) pins the adopted state bitwise to the live
    parameters;
  * **model push**: ``harness/stream_serve.py`` tails the shared directory
    with a :class:`StreamReader` and publishes exact snapshots for
    read-only eval/serving replicas.

Every shared-directory commit is ``<path>.<pid>.tmp`` + ``os.replace``; the
``stream/*`` stat keys are declared in :mod:`tpu_compressed_dp_torch.obs.registry`.
"""

from tpu_compressed_dp_torch.stream.delta import (apply_delta, flatten_params, flush_delta,
                                                  keep_for_ratio, residual_of, topk_delta,
                                                  unflatten_dict, unflatten_like)
from tpu_compressed_dp_torch.stream.reader import StreamReader
from tpu_compressed_dp_torch.stream.rejoin import warm_rejoin
from tpu_compressed_dp_torch.stream.store import (STREAM_SCHEMA, StreamCorrupt, head_path,
                                                  is_stream_dir, list_segments, load_segment,
                                                  prune_segments, read_head,
                                                  read_segment_manifest, segment_manifest_path,
                                                  segment_payload_path, verify_segment,
                                                  verify_stream, write_segment)
from tpu_compressed_dp_torch.stream.writer import StreamWriter

__all__ = [
    "STREAM_SCHEMA", "StreamCorrupt", "StreamWriter", "StreamReader",
    "warm_rejoin", "write_segment", "read_head", "head_path",
    "is_stream_dir", "list_segments", "load_segment",
    "read_segment_manifest", "segment_payload_path",
    "segment_manifest_path", "verify_segment", "verify_stream",
    "prune_segments", "flatten_params", "unflatten_like", "unflatten_dict",
    "topk_delta", "flush_delta", "apply_delta", "keep_for_ratio",
    "residual_of",
]
