"""Per-hashtag WER analysis with confidence intervals.

Copy of notsofar_tpu/utils/results_analysis.py (numpy, pandas, scipy; no
framework), the NOTSOFAR baseline's utils/results_analysis.py: per-hashtag
mean tcpWER/tcORC-WER with Student-t or bootstrap CIs of the mean, meeting-
level grouping (sessions of a meeting are not i.i.d.), A-B system-difference
mode, #TalkNearWhiteboard gathering, and errorbar plotting (matplotlib,
imported only by the plotting function).
"""
from typing import Tuple, Union

import numpy as np
import pandas as pd
from scipy.stats import t as t_dist


def calculate_confidence_interval_of_mean(
        data: Union[np.ndarray, list, pd.Series], confidence_level: float,
        bootstrap_samples: int = 0) -> Tuple[float, float]:
    """CI of the mean: Student-t (default) or percentile bootstrap."""
    data = np.asarray(data, dtype=float)
    if bootstrap_samples > 0:
        means = [np.mean(np.random.choice(data, size=len(data), replace=True))
                 for _ in range(bootstrap_samples)]
        lo = np.percentile(means, (1 - confidence_level) / 2 * 100)
        hi = np.percentile(means, (1 + confidence_level) / 2 * 100)
        return (float(lo), float(hi))
    mean = data.mean()
    std = data.std(ddof=1)
    n = len(data)
    return tuple(t_dist.interval(confidence_level, n - 1, loc=mean,
                                 scale=std / np.sqrt(n)))


class ResultsAnalyser:
    """WER-vs-metadata analysis; optionally on the difference between two
    systems (tighter CIs via paired comparison)."""

    def __init__(self, all_session_wer_df: pd.DataFrame,
                 all_gt_metadata_df: pd.DataFrame,
                 all_session_wer_ref_df: pd.DataFrame = None):
        self.all_session_wer_df = all_session_wer_df.copy()
        self.all_gt_metadata_df = all_gt_metadata_df
        self.all_session_wer_df["meeting_id"] = \
            self.all_session_wer_df["session_id"].str.extract(r"(MTG_\d+)")
        self.merged = pd.merge(self.all_session_wer_df, all_gt_metadata_df,
                               on="meeting_id")
        self.ref_df = all_session_wer_ref_df
        if all_session_wer_ref_df is not None:
            assert all_session_wer_ref_df["session_id"].equals(
                all_session_wer_df["session_id"]), \
                "Tested and reference results must align on sessions."
            self.ref_df = all_session_wer_ref_df.copy()
            self.ref_df["meeting_id"] = \
                self.ref_df["session_id"].str.extract(r"(MTG_\d+)")
            self.ref_merged = pd.merge(self.ref_df, all_gt_metadata_df,
                                       on="meeting_id")

    def metadata_analysis(self, gather_near_whiteboard: bool = True,
                          verbose: bool = False,
                          min_samples_for_ci: int = 20,
                          confidence_level: float = 0.95,
                          ci_over_sessions: bool = False,
                          bootstrap_samples: int = 0,
                          plot_results: bool = False) -> pd.DataFrame:
        assert 0 <= confidence_level < 1
        df = self.merged.copy()
        if self.ref_df is not None:
            df["tcp_wer"] = self.ref_merged["tcp_wer"] - \
                self.all_session_wer_df["tcp_wer"]
            df["tcorc_wer"] = self.ref_merged["tcorc_wer"] - \
                self.all_session_wer_df["tcorc_wer"]

        if not ci_over_sessions:
            grouped = df.groupby("meeting_id", group_keys=False)
            numeric_cols = df.select_dtypes(include=[np.number]).columns
            numeric = grouped[numeric_cols].mean()
            assert grouped["Hashtags"].nunique().eq(1).all(), \
                "All sessions' Hashtags per meeting must match."
            non_numeric_cols = df.select_dtypes(exclude=[np.number]).columns
            non_numeric = grouped[non_numeric_cols].first()
            items = pd.concat([numeric, non_numeric], axis=1)
        else:
            items = df

        def ci_pair(sub):
            if len(sub) >= min_samples_for_ci:
                return (calculate_confidence_interval_of_mean(
                            sub["tcp_wer"], confidence_level, bootstrap_samples),
                        calculate_confidence_interval_of_mean(
                            sub["tcorc_wer"], confidence_level, bootstrap_samples))
            return ((np.nan, np.nan), (np.nan, np.nan))

        tcp_ci, tcorc_ci = ci_pair(items)
        results = {"all_items": dict(
            tcp_wer=items["tcp_wer"].mean(), tcp_wer_ci=tcp_ci,
            tcorc_wer=items["tcorc_wer"].mean(), tcorc_wer_ci=tcorc_ci,
            confidence_level=confidence_level, len=len(items))}
        if verbose:
            print(f"mean tcp_wer of all items ({len(items)}) = "
                  f"{results['all_items']['tcp_wer']}")

        hashtags = items["Hashtags"].str.split(", ").explode().unique()
        if gather_near_whiteboard:
            hashtags = np.append(hashtags, "#TalkNearWhiteboard")
        for tag in hashtags:
            if tag == "#TalkNearWhiteboard":
                sub = items[items["Hashtags"].str.contains(tag, regex=False)]
            else:
                sub = items[items["Hashtags"].str.split(", ")
                            .apply(lambda x: tag in x)]
            tcp_ci, tcorc_ci = ci_pair(sub)
            results[tag] = dict(
                tcp_wer=sub["tcp_wer"].mean(), tcp_wer_ci=tcp_ci,
                tcorc_wer=sub["tcorc_wer"].mean(), tcorc_wer_ci=tcorc_ci,
                confidence_level=confidence_level, len=len(sub))
            if verbose:
                print(f"mean tcp_wer of {tag} ({len(sub)}) = "
                      f"{results[tag]['tcp_wer']}")

        results_df = pd.DataFrame.from_dict(results, orient="index")
        if plot_results:
            plot_metadata_results(results_df)
        return results_df


def plot_metadata_results(results_df: pd.DataFrame,
                          fig_size: Tuple = (20, 12), font_size: int = 20):
    """Errorbar plot of per-hashtag mean WER with CIs."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(1, 2, figsize=fig_size)
    for i, wer_type in enumerate(["tcp_wer", "tcorc_wer"]):
        means = results_df[wer_type]
        cis = results_df[f"{wer_type}_ci"]
        lo = np.array([means.iloc[j] - cis.iloc[j][0]
                       for j in range(len(means))])
        hi = np.array([cis.iloc[j][1] - means.iloc[j]
                       for j in range(len(means))])
        for j in range(len(results_df.index)):
            color = "red" if np.isnan(lo[j]) else "blue"
            ax[i].errorbar(results_df.index[j], means.iloc[j],
                           yerr=[[np.nan_to_num(lo[j])],
                                 [np.nan_to_num(hi[j])]],
                           fmt="o", color=color)
        ax[i].set_xlabel("Hashtag", fontsize=font_size)
        ax[i].set_ylabel(f"Mean {wer_type}", fontsize=font_size)
        ax[i].tick_params(axis="x", rotation=90)
    plt.tight_layout()
    return fig
