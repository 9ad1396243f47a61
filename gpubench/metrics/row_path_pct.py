"""row_path_pct (%): the share of the format's real slots whose tile the
step kernel folds on its row path (a sorted tile with a row longer than the
ring's stage, whose long rows fold side by side), from the program's gauge
``psi_edge_tile_row_path_share``, which the format's plan sets when the
engine builds it; nothing where the program has no such gauge."""


def read(run):
    from repro_torch.obs import metrics
    family = metrics.get_registry().get("psi_edge_tile_row_path_share")
    return family.value * 100.0 if family is not None else None
