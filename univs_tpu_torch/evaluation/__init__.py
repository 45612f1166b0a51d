from univs_tpu_torch.evaluation.davis import db_eval_iou, db_eval_boundary, evaluate_davis_sequence
from univs_tpu_torch.evaluation.vss import confusion_matrix, miou_from_confusion, video_consistency
from univs_tpu_torch.evaluation.vpq import vpq_single_video
from univs_tpu_torch.evaluation.stq import STQAccumulator
from univs_tpu_torch.evaluation.ytvis import YTVISEval
