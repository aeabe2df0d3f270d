"""serve_mfu: the dense model's forward FLOPs a tile times the tiles served
in the traced window, as a share of the card's dense TF32 peak."""


def read(record):
    peak = (record.get("peaks") or {}).get("tf32")
    flops, tiles = record.get("tile_flops"), record.get("tiles")
    if not peak or not flops or not tiles or record["window_s"] <= 0:
        return None
    return 100.0 * flops * tiles / record["window_s"] / peak
