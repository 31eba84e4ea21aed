"""Stream-evaluation CLI on the port (counterpart of
``gwkit/cli/evaluate_stream.py``; host code, numpy and h5py: it needs no
card, and ``--cpu`` changes nothing).

Assembles per-file network-score HDF5s (dataset 'data' of shape (N, 2); GPS
start in the filename) into one continuous ranking series, extracts
triggers -> clusters -> events, splits true/false positives against the
injection table, and writes the FAR-per-month / sensitive-volume sweep.
Triggers and events persist to HDF5 (``--trigger-file-name``,
``--event-file-name``) and can be reloaded with ``--load-triggers`` or
``--load-events`` to skip the assembly stage.

    python -m gwkit_torch.cli.evaluate_stream --data-dir SCORES --injection-file inj.hdf \\
        [--load-triggers triggers.hdf | --load-events events.hdf --duration SECONDS]
"""
from __future__ import annotations

import logging
import os
from argparse import ArgumentParser

import numpy as np

from gwkit_torch.cli.common import add_common_args, check_file_existence, configure_logging, parse_with_config


def parse_args(argv=None):
    p = ArgumentParser(description="Evaluate a directory of per-file score series "
                                   "(FAR & sensitive-volume sweep).")
    add_common_args(p)
    p.add_argument("--data-dir", type=str, default=None,
                   help="Directory of per-file score HDF5s ('data' (N,2); GPS "
                        "start encoded in the filename, evaluate_test_data.py:20).")
    p.add_argument("--injection-file", type=str, required=True,
                   help="Injection table with tc/mass1/mass2/distance.")
    p.add_argument("--trigger-threshold", type=float, default=0.1)
    p.add_argument("--cluster-tolerance", type=float, default=0.2)
    p.add_argument("--event-tolerance", type=float, default=0.3)
    p.add_argument("--delta-t", type=float, default=0.1,
                   help="Stride between consecutive scores (s).")
    p.add_argument("--start-time-offset", type=float, default=0.75,
                   help="Offset added to each file's start time (the window's "
                        "merger position; reference default 0.75).")
    p.add_argument("--duration", type=float, default=None,
                   help="Observation duration (s); required with "
                        "--load-triggers/--load-events, else inferred.")
    p.add_argument("--test-data-activation", choices=["linear", "softmax"],
                   default="linear")
    p.add_argument("--ranking-statistic", choices=["softmax", "linear"],
                   default="softmax")
    p.add_argument("--trigger-file-name", type=str, default="triggers.hdf")
    p.add_argument("--event-file-name", type=str, default="events.hdf")
    p.add_argument("--stats-file-name", type=str, default="statistics.hdf")
    p.add_argument("--load-triggers", type=str, default=None,
                   help="Reuse a previously written trigger file.")
    p.add_argument("--load-events", type=str, default=None,
                   help="Reuse a previously written event file.")
    return parse_with_config(p, argv)


def main(argv=None):
    args = parse_args(argv)
    configure_logging(verbose=args.verbose, debug=args.debug)
    import h5py

    from gwkit_torch.evaluation.stream import assemble_score_series, load_score_files
    from gwkit_torch.search.cluster import (
        SECONDS_PER_MONTH,
        get_cluster_boundaries,
        get_event_list_from_triggers,
        get_triggers_from_series,
        split_true_and_false_positives,
    )

    if args.ranking_statistic == "linear" and args.test_data_activation != "linear":
        raise SystemExit("a linear ranking statistic needs linear test data")

    out_dir = args.data_dir or "."
    events = None
    triggers = None
    duration = args.duration
    if args.load_events is not None:
        with h5py.File(args.load_events, "r") as f:
            events = list(zip(f["times"][()], f["values"][()]))
        logging.info("loaded %d events from %s", len(events), args.load_events)
    elif args.load_triggers is not None:
        with h5py.File(args.load_triggers, "r") as f:
            triggers = np.vstack([f["data"][()], f["trigger_values"][()]])
        logging.info("loaded %d triggers from %s", triggers.shape[1], args.load_triggers)
    else:
        if args.data_dir is None:
            raise SystemExit("--data-dir is required unless triggers/events are loaded")
        series = load_score_files(
            args.data_dir, epoch_offset=args.start_time_offset,
            delta_t=args.delta_t, data_activation=args.test_data_activation,
            ranking=args.ranking_statistic)
        logging.info("loaded %d score files", len(series))
        values, times = assemble_score_series(series, delta_t=args.delta_t)
        if duration is None:
            duration = float(times[-1] - times[0])
        triggers = get_triggers_from_series(values, times, args.trigger_threshold)
        logging.info("found %d triggers", triggers.shape[1])
        trig_path = os.path.join(out_dir, args.trigger_file_name)
        check_file_existence(trig_path, args.force)
        with h5py.File(trig_path, "w") as f:
            f.create_dataset("data", data=triggers[0])
            f.create_dataset("trigger_values", data=triggers[1])
        logging.info("wrote triggers to %s", trig_path)
    if duration is None:
        raise SystemExit("--duration is required with --load-triggers/--load-events")

    if events is None:
        boundaries = get_cluster_boundaries(triggers, args.cluster_tolerance)
        events = get_event_list_from_triggers(triggers, boundaries)
        logging.info("found %d events in %d clusters", len(events), len(boundaries))
        event_path = os.path.join(out_dir, args.event_file_name)
        check_file_existence(event_path, args.force)
        with h5py.File(event_path, "w") as f:
            f.create_dataset("times", data=np.asarray([e[0] for e in events]))
            f.create_dataset("values", data=np.asarray([e[1] for e in events]))
        logging.info("wrote events to %s", event_path)

    with h5py.File(args.injection_file, "r") as f:
        inj_times = np.sort(f["tc"][()])
        have_params = all(k in f for k in ("mass1", "mass2", "distance"))

    tp, fp = split_true_and_false_positives(
        events, inj_times, args.event_tolerance, assume_sorted=True)
    logging.info("%d true / %d false positives", len(tp), len(fp))

    # rank sweep at every event value (the reference steps through the
    # sorted false-positive values; adding TP values refines the curve
    # between FP steps without changing it at them). Sensitive fraction
    # counts FOUND INJECTIONS, not TP events: each injection is credited
    # its loudest matching event.
    times_e = np.asarray([e[0] for e in events], np.float64)
    vals_e = np.asarray([e[1] for e in events], np.float64)
    idx = np.searchsorted(inj_times, times_e, side="right")
    lo = np.clip(idx - 1, 0, len(inj_times) - 1)
    hi = np.clip(idx, 0, len(inj_times) - 1)
    nearest = np.where(np.abs(times_e - inj_times[lo]) <= np.abs(times_e - inj_times[hi]), lo, hi)
    is_tp = np.minimum(np.abs(times_e - inj_times[lo]), np.abs(times_e - inj_times[hi])) \
        <= args.event_tolerance
    best = np.full(len(inj_times), -np.inf)
    np.maximum.at(best, nearest[is_tp], vals_e[is_tp])
    fp_vals = np.sort(vals_e[~is_tp])
    best = np.sort(best)
    thresholds = np.unique(vals_e)
    # side='left': an operating point AT an event's rank value includes it
    far = ((len(fp_vals) - np.searchsorted(fp_vals, thresholds, side="left"))
           / duration * SECONDS_PER_MONTH)
    sens_frac = ((len(best) - np.searchsorted(best, thresholds, side="left"))
                 / max(len(inj_times), 1))

    stats_path = os.path.join(out_dir, args.stats_file_name)
    check_file_existence(stats_path, args.force)
    with h5py.File(stats_path, "w") as f:
        f.create_dataset("rank", data=thresholds)
        f.create_dataset("far", data=far)
        f.create_dataset("sens-frac", data=sens_frac)
        f.attrs["duration"] = duration
        f.attrs["n-injections"] = len(inj_times)
        f.attrs["has-params"] = have_params
    logging.info("wrote statistics to %s", stats_path)
    print(f"{len(tp)} true / {len(fp)} false positives over {duration:.0f}s; "
          f"stats at {stats_path}")


if __name__ == "__main__":
    main()
