"""Training engine (counterpart of ``custom_yolo_tpu/train``): assigners,
losses, optimizer and plateau schedule, train state, train and eval steps."""
