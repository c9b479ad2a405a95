from .pipeline import compute_clip_flow, process_folder, process_video
from .segment import LABEL_MAPS, clean_mask, predict_movie, predict_movie_thres

__all__ = ["clean_mask", "predict_movie_thres", "predict_movie", "LABEL_MAPS",
           "process_video", "compute_clip_flow", "process_folder"]
