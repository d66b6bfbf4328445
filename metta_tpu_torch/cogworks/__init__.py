from metta_tpu_torch.cogworks.curriculum import (
    BucketedTaskGenerator,
    Curriculum,
    CurriculumConfig,
    CurriculumTask,
    DiscreteRandomConfig,
    LearningProgressAlgorithm,
    LearningProgressConfig,
    SliceAnalyzer,
    TaskGenerator,
    bucketed,
)

__all__ = [
    "BucketedTaskGenerator", "Curriculum", "CurriculumConfig", "CurriculumTask",
    "DiscreteRandomConfig", "LearningProgressAlgorithm", "LearningProgressConfig",
    "SliceAnalyzer", "TaskGenerator", "bucketed",
]
