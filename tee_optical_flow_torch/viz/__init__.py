from .manager import VisualizationManager

__all__ = ["VisualizationManager"]
