#!/usr/bin/env bash
# The port's measurement entry points on one card, run as a user runs
# them. From the repository root:
#   scripts/torch_chip_tools.sh small [ROUNDS]  # ~4 min: raft_tpu_torch.bench
#       (32k reads, ROUNDS rounds, default 3), bench_fetch, bench_pileup;
#       bench_scale / bench_chunk / bench_gz_scale at 20k reads x 30 rows
#   scripts/torch_chip_tools.sh scale   # ~15 min: bench_scale at its
#       defaults (524,288 reads x 60 rows, ~12.4 GB of FASTA) twice, then
#       bench_chunk --disk-bw on its dataset, auto and --chunk 32768
#   scripts/torch_chip_tools.sh gz [READS]  # bench_gz_scale on
#       bench_scale's dataset cut to READS reads (default 524,288: ~40 min,
#       most of it one serial gzip -5 of 12.4 GB). It holds the dataset, its
#       gz and BGZF copies and three runs' outputs at once: ~67 GB at the
#       default, ~34 GB at 262,144 reads.
#   scripts/torch_chip_tools.sh corner [READS]  # bench_scale --reads
#       READS (default 4000000) --mean-len 2500: the many-small-reads corner
# Each tool's JSON line and stderr go to $RAFT_TOOLS_OUT/tools_<mode>/
# (default: raft_tools_out under the temporary directory); the lines are
# printed, with the card, the free disk and the host memory.
set -u
mode=${1:-small}
out=${RAFT_TOOLS_OUT:-${TMPDIR:-/tmp}/raft_tools_out}/tools_$mode
mkdir -p "$out"
tmp=${TMPDIR:-/tmp}/raft_tools
rm -rf "$tmp"
mkdir -p "$tmp"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version.split()[0], torch.__version__, torch.version.cuda)'
echo "nproc $(nproc)"
df -B1 "$tmp" | tail -1
free -g | head -2
rc=0
run() {  # name, then the command
    local name=$1
    shift
    local t0=$SECONDS
    "$@" > "$out/$name.json" 2> "$out/$name.err"
    local r=$?
    echo "== $name: rc $r, $((SECONDS - t0)) s, $(df -B1 --output=avail "$tmp" | tail -1) B free"
    tail -c 3000 "$out/$name.json"
    [ $r -eq 0 ] || { rc=1; tail -c 2000 "$out/$name.err"; }
}
big() {  # dir, reads: bench_scale's dataset, generated as it does
    mkdir -p "$1"
    python -c "from raft_tpu_torch.tools.benchgen import gen_dataset
gen_dataset('$1/scale$2', n_reads=$2, n_overlaps=$2 * 60, est_cov=20)"
}
case $mode in
small)
    export RAFT_BENCH_DIR=$tmp/bench RAFT_BENCH_ROUNDS=${2:-3}
    run bench python -m raft_tpu_torch.bench
    run bench_fetch python -m raft_tpu_torch.tools.bench_fetch
    run bench_pileup python -m raft_tpu_torch.tools.bench_pileup
    sc=$tmp/scale
    run bench_scale python -m raft_tpu_torch.tools.bench_scale \
        --reads 20000 --rows-per-read 30 --chunk 8192 --dir "$sc" \
        --keep-outputs
    run bench_chunk python -m raft_tpu_torch.tools.bench_chunk \
        --reads "$sc/scale20000.reads.fasta" \
        --paf "$sc/scale20000.overlaps.paf" --workdir "$sc/chunk" \
        --chunk 8192 --expect "$sc/out_whole"
    run bench_gz_scale python -m raft_tpu_torch.tools.bench_gz_scale \
        --reads "$sc/scale20000.reads.fasta" \
        --paf "$sc/scale20000.overlaps.paf" --dir "$sc/gz"
    ;;
scale)
    d=$tmp/big
    run bench_scale_1 python -m raft_tpu_torch.tools.bench_scale --dir "$d"
    run bench_scale_2 python -m raft_tpu_torch.tools.bench_scale --dir "$d" \
        --keep-outputs
    rm -f "$d"/out_chunk.*
    for label in auto c32768; do
        chunk=()
        [ $label = auto ] || chunk=(--chunk 32768)
        run bench_chunk_$label python -m raft_tpu_torch.tools.bench_chunk \
            --reads "$d/scale524288.reads.fasta" \
            --paf "$d/scale524288.overlaps.paf" --workdir "$d/chunk" \
            --disk-bw --label $label "${chunk[@]}" --expect "$d/out_whole"
        cp "$d/chunk/decomp_$label.trace.jsonl" "$out/"
        rm -f "$d/chunk/decomp_$label".*
    done
    ;;
gz)
    d=$tmp/big
    n=${2:-524288}
    t0=$SECONDS
    big "$d" "$n"
    echo "== dataset: $((SECONDS - t0)) s"
    run bench_gz_scale python -m raft_tpu_torch.tools.bench_gz_scale \
        --reads "$d/scale$n.reads.fasta" --paf "$d/scale$n.overlaps.paf" \
        --dir "$d/gz"
    ;;
corner)
    run bench_scale_corner python -m raft_tpu_torch.tools.bench_scale \
        --reads "${2:-4000000}" --mean-len 2500 --dir "$tmp/corner"
    ;;
*)
    echo "unknown mode $mode" >&2
    rc=2
    ;;
esac
rm -rf "$tmp"
exit $rc
