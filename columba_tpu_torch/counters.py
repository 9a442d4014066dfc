"""Run counters and end-of-run statistics report.

Mirrors the reference's Counters subsystem (reference:
src/indexhelpers.h:1846-1941 counter enum, src/indexhelpers.cpp:388-513
``reportStatistics``): per-chunk counters merged into one aggregate and
reported at the end of the run, with the same line wording; VERBOSE-gated
lines need -v, like the reference's logVerbose.

On device, counters are integer outputs of the jitted match step (psum'd
across the mesh in the multi-chip path, dist/mesh.py); this class is the
host-side accumulator fed per batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Counters:
    number_of_reads: int = 0          # SE reads (PE: total reads = 2/pair)
    mapped_reads: int = 0
    total_unique_matches: int = 0     # occurrences after filtering
    total_reported_positions: int = 0  # SAM records emitted
    node_counter: int = 0             # frontier extensions (device)
    search_started: int = 0
    in_text_started: int = 0
    aborted_in_text: int = 0
    cigars_computed: int = 0
    lossless_retries: int = 0         # spill/overflow re-dispatches (4x grow)
    # paired-end
    total_unique_pairs: int = 0
    mapped_pairs: int = 0
    discordantly_mapped_pairs: int = 0
    mapped_half_pairs: int = 0        # only one side mapped
    unpaired_but_mapped_pairs: int = 0
    extra: dict = field(default_factory=dict)

    def add_device_stats(self, stats: dict):
        self.node_counter += stats.get("nodes_visited", 0)
        self.in_text_started += stats.get("itv_started", 0)
        self.search_started += stats.get("searches_started", 0)
        self.aborted_in_text += stats.get("aborted_in_text", 0)
        self.lossless_retries += stats.get("retries", 0)
        if stats.get("locate_truncated"):
            # reachable with an explicit (non-auto) max_locate, or when the
            # auto-sized path exhausts its 3 lossless growth retries in
            # match_all_finish/match_all_start and still overflows
            from columba_tpu_torch.logger import logger

            logger.warning(
                "locate/verify capacity exceeded even after retries — "
                "occurrences were dropped; raise max_locate")

    def report(self, logger, paired: bool = False):
        n = self.number_of_reads
        if n:
            logger.verbose_msg(
                f"Average no. nodes: {self.node_counter / n:g}")
        logger.verbose_msg(f"Total no. Nodes: {self.node_counter}")
        if not paired:
            if n:
                logger.info(
                    "Average no. unique matches per read: "
                    f"{self.total_unique_matches / n:g}")
            logger.info(f"Total no. matches: {self.total_unique_matches}")
            if n:
                logger.verbose_msg(
                    "Average no. matches per read "
                    f"{self.total_reported_positions / n:g}")
            logger.verbose_msg(
                f"Total no. reported matches: {self.total_reported_positions}")
            logger.info(f"Mapped reads: {self.mapped_reads}")
            logger.info(f"Number of reads: {n}")
            if n:
                logger.info(
                    "Percentage reads mapped: "
                    f"{self.mapped_reads * 100.0 / n:g}%")
        else:
            pairs = n // 2
            if pairs:
                logger.info(
                    "Average no. matches per pair: "
                    f"{self.total_unique_pairs / pairs:g}")
            logger.info(f"Total no. matches : {self.total_unique_pairs}")
            logger.info(f"Mapped pairs: {self.mapped_pairs}")
            if pairs:
                logger.info(
                    "Percentage of pairs mapped: "
                    f"{self.mapped_pairs * 100.0 / pairs:g}%")
            logger.info(
                f"Discordantly mapped pairs: {self.discordantly_mapped_pairs}")
            if pairs:
                logger.info(
                    "Percentage of discordantly mapped pairs: "
                    f"{self.discordantly_mapped_pairs * 100.0 / pairs:g}%")
            logger.info(
                f"No. unpaired reads that did match: {self.mapped_half_pairs}")
            logger.info(
                "Total read pairs both mapped but unpaired: "
                f"{self.unpaired_but_mapped_pairs}")
        logger.verbose_msg(
            f"In text verification procedures {self.in_text_started}")
        logger.verbose_msg(
            f"Failed in-text verifications procedures: {self.aborted_in_text}")
        if self.in_text_started:
            logger.verbose_msg(
                "Aborted in-text relative to started "
                f"{self.aborted_in_text / self.in_text_started:g}")
        else:
            logger.verbose_msg(
                "Aborted in-text relative to started: N/A (No in-text "
                "verifications started)")
        # NOTE: this framework counts (read, search) frontier lanes alive
        # entering the band phase — a batched proxy for the reference's
        # SEARCH_STARTED (which counts searches entered after
        # immediate-switch skips, src/indexinterface.cpp:377-527). The
        # label says so to avoid implying reference-identical semantics.
        logger.verbose_msg(
            f"Searches started (band-phase frontier lanes; batched proxy, "
            f"excludes immediate switches) : {self.search_started}")
        logger.verbose_msg(f"CIGAR strings computed: {self.cigars_computed}")
        logger.verbose_msg(
            f"Lossless spill retries (4x re-dispatches): "
            f"{self.lossless_retries}")
