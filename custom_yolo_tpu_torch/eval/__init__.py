from custom_yolo_tpu_torch.eval.metrics import DetectionMetrics  # noqa: F401
from custom_yolo_tpu_torch.eval.decode import decode_predictions  # noqa: F401
from custom_yolo_tpu_torch.eval.coco_map import COCOmAP  # noqa: F401
