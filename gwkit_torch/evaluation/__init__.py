"""Evaluation (counterpart of ``gwkit/evaluation``): the MLGWSC-1 challenge
statistics (FAR curves, the sensitive volume and distance) and the
score-stream sweep, numpy on the host and equal to gwkit's outputs
exactly; and detection efficiencies, whose scores come from the model on
its device."""
from gwkit_torch.evaluation.efficiency import EfficiencyEstimator, write_efficiency_table
from gwkit_torch.evaluation.mlgwsc import find_injection_times, get_stats, mchirp, read_events
from gwkit_torch.evaluation.sensitivity import sensitive_distance, volume_montecarlo
from gwkit_torch.evaluation.stream import (StreamEvalResult, assemble_score_series, convert_activation,
                                           evaluate_score_stream, load_score_files, scores_to_series,
                                           start_time_from_filename)

__all__ = ["EfficiencyEstimator", "write_efficiency_table", "find_injection_times", "get_stats", "mchirp",
           "read_events", "sensitive_distance", "volume_montecarlo", "StreamEvalResult", "assemble_score_series",
           "convert_activation", "evaluate_score_stream", "load_score_files", "scores_to_series",
           "start_time_from_filename"]
