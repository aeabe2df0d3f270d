from .sbd import best_dice, symmetric_best_dice, diff_fg_labels, abs_diff_fg_labels
from .voi_arand import voi, adapted_rand_error
