from .pipeline import compute_clip_flow, process_folder, process_video

__all__ = ["compute_clip_flow", "process_folder", "process_video"]
