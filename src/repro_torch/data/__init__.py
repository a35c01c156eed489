from .traffic import (EMPIRICAL, NET_KNOBS, SYNTH_DISTS, TABLE2_SPACE,
                      Scenario, sample_point, sample_scenario, sample_sizes,
                      traffic_matrix)

__all__ = ["EMPIRICAL", "NET_KNOBS", "SYNTH_DISTS", "TABLE2_SPACE",
           "Scenario", "sample_point", "sample_scenario", "sample_sizes",
           "traffic_matrix"]
