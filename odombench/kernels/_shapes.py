"""The cell's shapes that the kernel counts read."""


def shapes(cell):
    p = cell.config["pipeline"]
    s, m, r = p["sensor"], p["map"], p["registration"]
    return {"nq": s["max_surface_features"], "k": r["plane_knn"],
            "C": m["cell_capacity"], "bucket": m["bucket_size"],
            "rounds": r["max_icp_iters"], "gn_iters": r["max_gn_iters"],
            "thin": s["scan_thin_mode"],
            "lanes": -(-s["max_points"] // s["filter_point_size"])
            if s["filter_point_size"] > 1 else s["max_points"],
            "refresh": r["refresh_width"], "edges": p["use_edge_features"]}
