from repro_torch.metrics.scores import (dice_coefficient, dose_score, dvh_score,
                                        one_way_anova)

__all__ = ["dose_score", "dvh_score", "dice_coefficient", "one_way_anova"]
