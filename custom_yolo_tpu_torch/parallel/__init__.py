"""Distributed training and multi-card serving (counterpart of
``custom_yolo_tpu/parallel``): collectives, rank alignment, the dp and
fsdp wrappers and sharded serving."""
