from .sbd import (best_dice, symmetric_best_dice, symmetric_best_dice_max, diff_fg_labels,
                  abs_diff_fg_labels, mean_iou, fgbg_dice)
from .voi_arand import voi, adapted_rand_error
from .bbbc import agg_jc_index, pixel_f1, remap_label, get_fast_pq
