from .processor import BatchProcessor, analyze_hdf5_folder
from .cohort import analyze_cohort_file, run_cohort_analysis

__all__ = ["BatchProcessor", "analyze_hdf5_folder", "analyze_cohort_file",
           "run_cohort_analysis"]
