from .sbd import best_dice, symmetric_best_dice, diff_fg_labels, abs_diff_fg_labels
from .voi_arand import voi, adapted_rand_error
from .bbbc import agg_jc_index, pixel_f1, remap_label, get_fast_pq
