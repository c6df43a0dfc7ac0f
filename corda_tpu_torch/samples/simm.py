"""ISDA-SIMM-style initial margin across all six published risk classes.

Reference: samples/simm-valuation-demo/ delegates the maths to
OpenGamma's implementation of the ISDA Standard Initial Margin Model.
This module implements the published SIMM *structure* — the interest
-rate risk class with delta, vega AND curvature layers, the FX delta
risk class, Equity/Commodity bucketed delta classes, the two Credit
(qualifying / non-qualifying) CS01 classes with same-vs-different
issuer correlation and residual buckets, and the cross-risk-class psi
aggregation — instead of a toy heuristic:

  1. per-trade sensitivities bucketed onto the SIMM tenor vertices
     (curve-priced ladders come from samples/pricing.py);
  2. weighted sensitivities WS_k = RW_k * s_k (risk weight per tenor;
     vega uses the scalar IR VRW);
  3. intra-bucket (per-currency) aggregation
     K_b = sqrt( WS^T . rho . WS ) with a tenor-tenor correlation
     matrix;
  4. cross-bucket aggregation
     M = sqrt( sum_b K_b^2 + sum_{b!=c} gamma * S_b * S_c ),
     S_b = clamp(sum_k WS_bk, -K_b, K_b);
  5. curvature from scaled vega (CVR = SF(t) * vega) through the
     squared-correlation aggregation with the lambda/theta tail factor
     (`curvature_margin`); risk-class IM = delta + vega + curvature;
  6. FX delta: one bucket, per-currency sensitivities to a 1% spot
     move, scalar risk weight, uniform 0.5 FX-FX correlation
     (`fx_margin`);
  7. Equity and Commodity delta: per-bucket scalar risk weights and
     intra-bucket correlations over per-name sensitivities to a 1%
     relative move, a flat cross-bucket gamma (representative of the
     published per-pair tables), and — for equity — a RESIDUAL bucket
     whose K adds OUTSIDE the cross-bucket square root
     (`equity_margin`, `commodity_margin`);
  8. CreditQ / CreditNonQ delta: per-(issuer, tenor) CS01 ladders on
     the five published credit vertices, intra-bucket correlation
     split into same-issuer rho and different-issuer rho, bucketed
     risk weights + gamma, residual bucket (`credit_q_margin`,
     `credit_nonq_margin`);
  9. cross-risk-class aggregation over the six published risk classes
     SIMM = sqrt( sum_r IM_r^2 + sum_{r!=s} psi_rs IM_r IM_s )
     (`product_margin` with the representative `RISK_CLASS_PSI`).

Weights/correlations are representative of SIMM calibrations
(risk weights in bp, correlation decaying with tenor distance with the
published long-range floor); exact ISDA parameter tables are
versioned + licensed, so this stays a faithfully-shaped, openly
parameterised calculator — the ledger only needs both parties to run
the SAME deterministic function (float64 op order fixed below).

The CONSENSUS margin runs in fixed-order float64 numpy (bit-for-bit
reproducible across parties); `estimate_margins_batch` offers the same
quadratic form as one batched device contraction for analytics-scale
valuation sweeps — the heavy-compute core of why the reference demo
exists, but never the recorded number.

Port of corda_tpu/samples/simm.py. The consensus path is the
reference's float64 numpy in the reference's operation order, so both
packages agree to the bit; `estimate_margins_batch` is a float32
`torch.einsum` on the card (TF32 off, the reference's
`precision="highest"`).
"""

from __future__ import annotations

import math

import numpy as np

# SIMM tenor vertices, in years (the 12 IR delta vertices)
TENORS_Y = (
    2 / 52, 1 / 12, 0.25, 0.5, 1.0, 2.0, 3.0, 5.0, 10.0, 15.0, 20.0, 30.0
)
N_TENORS = len(TENORS_Y)

# representative per-tenor risk weights, basis points of sensitivity
RISK_WEIGHTS_BP = (
    114.0, 115.0, 102.0, 71.0, 61.0, 52.0, 50.0, 51.0, 51.0, 50.0, 54.0, 63.0
)

CROSS_CCY_GAMMA = 0.32      # cross-bucket (currency) correlation

# representative IR vega risk weight (SIMM publishes one scalar VRW
# for the whole IR vega risk class)
VEGA_RISK_WEIGHT = 0.21

# Phi^-1(0.995) — the 99.5% normal quantile in the SIMM curvature
# lambda; a fixed constant so both parties share one literal rather
# than each inverting the normal CDF
PHI_INV_995 = 2.5758293035489004

# FX delta risk class: ONE bucket, a scalar risk weight applied to the
# per-currency sensitivity to a 1% relative spot move, and the
# published uniform 0.5 correlation between currency pairs
FX_RISK_WEIGHT = 8.1
FX_CORR = 0.5

# the six published SIMM risk classes, in the fixed aggregation order
RISK_CLASSES = ("IR", "CreditQ", "CreditNonQ", "Equity", "Commodity", "FX")

# representative cross-risk-class correlations psi_rs (the published
# SIMM tables carry exact, versioned values; the structure — a fixed
# symmetric PSD matrix over the six classes — is what consensus needs)
RISK_CLASS_PSI = np.array(
    [
        # IR    CrQ   CrNQ  Eq    Comm  FX
        [1.00, 0.29, 0.13, 0.28, 0.46, 0.32],   # IR
        [0.29, 1.00, 0.54, 0.71, 0.52, 0.38],   # CreditQ
        [0.13, 0.54, 1.00, 0.46, 0.41, 0.12],   # CreditNonQ
        [0.28, 0.71, 0.46, 1.00, 0.49, 0.35],   # Equity
        [0.46, 0.52, 0.41, 0.49, 1.00, 0.41],   # Commodity
        [0.32, 0.38, 0.12, 0.35, 0.41, 1.00],   # FX
    ],
    dtype=np.float64,
)


def tenor_correlation() -> np.ndarray:
    """[K, K] tenor-tenor correlation: exp decay in log-tenor distance
    with the SIMM-style long-range floor."""
    t = np.asarray(TENORS_Y, dtype=np.float64)
    lt = np.log(t)
    d = np.abs(lt[:, None] - lt[None, :])
    rho = np.maximum(np.exp(-0.35 * d), 0.27)
    np.fill_diagonal(rho, 1.0)
    return rho


_RHO = tenor_correlation()
_RW = np.asarray(RISK_WEIGHTS_BP, dtype=np.float64)


def vertex_split(
    vertices: tuple, t: float, value: float
) -> np.ndarray:
    """[len(vertices)] ladder placing `value` linearly between the two
    vertices framing `t` (standard vertex interpolation, clamped to
    the vertex range) — shared by the IR tenor and credit vertex
    grids."""
    s = np.zeros(len(vertices), dtype=np.float64)
    t = max(min(t, vertices[-1]), vertices[0])
    hi = next(i for i, v in enumerate(vertices) if v >= t)
    if vertices[hi] == t:
        s[hi] = value
        return s
    lo = hi - 1
    frac = (t - vertices[lo]) / (vertices[hi] - vertices[lo])
    s[lo] = value * (1.0 - frac)
    s[hi] = value * frac
    return s


def bucket_pv01(
    notional: int, years_to_maturity: float
) -> np.ndarray:
    """[K] PV01-style delta ladder for a vanilla swap: DV01 of the
    fixed leg, split linearly between the two tenor vertices framing
    maturity (standard vertex interpolation)."""
    return vertex_split(
        TENORS_Y, years_to_maturity,
        notional * years_to_maturity / 10_000.0,
    )


def _ks(ws: np.ndarray, rho: np.ndarray):
    """Weighted sensitivities [P, K] -> ([P] K_b, [P] S_b) under the
    given tenor correlation: K_b = sqrt(WS^T rho WS),
    S_b = clamp(sum WS, -K_b, K_b). Shared quadratic core of the
    delta, vega and curvature layers."""
    q = np.einsum("pk,kl,pl->p", ws, rho, ws)
    k = np.sqrt(np.maximum(q, 0.0))
    s = np.clip(ws.sum(axis=1), -k, k)
    return k, s


def bucket_margins(sensitivities: np.ndarray):
    """[P, K] per-bucket DELTA sensitivity ladders -> (K_b, S_b).

    CONSENSUS PATH: float64 numpy with a fixed op order — both parties
    must reproduce the margin bit-for-bit, and the card's float32
    would not. The card belongs to analytics-scale estimation
    (estimate_margins_batch), never to the agreed number."""
    return _ks(sensitivities * _RW[None, :], _RHO)


def vega_bucket_margins(vegas: np.ndarray):
    """[P, K] per-bucket VEGA ladders -> (K_b, S_b): same correlation
    structure as delta with the scalar IR vega risk weight."""
    return _ks(vegas * VEGA_RISK_WEIGHT, _RHO)


def scaling_function(t_years: float) -> float:
    """SIMM curvature scaling SF(t) = 0.5 * min(1, 14 days / t)."""
    return 0.5 * min(1.0, 14.0 / (365.0 * max(t_years, 1e-12)))


_SF = np.asarray([scaling_function(t) for t in TENORS_Y], dtype=np.float64)


def curvature_ladders(vegas: np.ndarray) -> np.ndarray:
    """[P, K] vega ladders -> [P, K] curvature exposures
    CVR_k = SF(t_k) * vega_k (the SIMM vega-derived gamma proxy)."""
    return vegas * _SF[None, :]


def curvature_margin(cvr: np.ndarray) -> float:
    """Published SIMM curvature aggregation over [P, K] CVR ladders:

      K_b   = sqrt( CVR^T rho^2 CVR )          (correlations squared)
      S_b   = clamp(sum CVR, -K_b, K_b)
      theta = min( sum CVR / sum |CVR|, 0 )
      lam   = (Phi^-1(0.995)^2 - 1) * (1 + theta) - theta
      CM    = max( sum CVR + lam * sqrt( sum K_b^2
                   + sum_{b!=c} gamma^2 S_b S_c ), 0 )
    """
    abs_total = float(np.abs(cvr).sum())
    if abs_total == 0.0:
        return 0.0
    total = float(cvr.sum())
    k, s = _ks(cvr, _RHO * _RHO)
    theta = min(total / abs_total, 0.0)
    lam = (PHI_INV_995 * PHI_INV_995 - 1.0) * (1.0 + theta) - theta
    inner = float(np.dot(k, k))
    cross = float(s.sum() ** 2 - np.dot(s, s))
    agg = math.sqrt(
        max(inner + (CROSS_CCY_GAMMA * CROSS_CCY_GAMMA) * cross, 0.0)
    )
    return max(total + lam * agg, 0.0)


def estimate_margins_batch(sensitivities: np.ndarray, device=None) -> np.ndarray:
    """[P, K] -> [P] float32 per-bucket K estimates as ONE device
    contraction on `device` (default: the card, "cuda"; a CPU caller
    passes device="cpu") — the demo's heavy-compute shape (value
    thousands of portfolios per dispatch). ANALYTICS ONLY: runs in
    float32 with TF32 off (the reference's precision="highest"), so it
    may differ from the consensus float64 path in the last digits;
    anything recorded on ledger must come from bucket_margins/simm_im.
    Without a card the default device raises; nothing falls back to the
    CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    ws = torch.as_tensor(sensitivities * _RW[None, :], dtype=torch.float32, device=dev)
    rho = torch.as_tensor(_RHO, dtype=torch.float32, device=dev)
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        q = torch.einsum("pk,kl,pl->p", ws, rho, ws)
    finally:
        torch.set_float32_matmul_precision(prev)
    return torch.sqrt(torch.clamp(q, min=0.0)).cpu().numpy()


def aggregate_margin(k: np.ndarray, s: np.ndarray) -> float:
    """Cross-bucket SIMM aggregation over per-bucket (K_b, S_b)."""
    total = float(np.dot(k, k))
    cross = float(s.sum() ** 2 - np.dot(s, s))
    return math.sqrt(max(total + CROSS_CCY_GAMMA * cross, 0.0))


def fx_margin(fx_deltas: dict[str, float]) -> float:
    """FX delta margin over {currency: PV change per +1% spot move}
    sensitivities: single bucket, WS_i = FX_RISK_WEIGHT * s_i,
    K = sqrt( sum_i WS_i^2 + FX_CORR * sum_{i!=j} WS_i WS_j ).
    Fixed currency order (sorted) keeps the float64 op order shared."""
    if not fx_deltas:
        return 0.0
    ws = (
        np.asarray(
            [fx_deltas[c] for c in sorted(fx_deltas)], dtype=np.float64
        )
        * FX_RISK_WEIGHT
    )
    return _scalar_bucket_k(ws, FX_CORR)


# ---------------------------------------------------------------------------
# Equity / Commodity: bucketed delta classes over per-name sensitivities
#
# Published structure: sensitivities are per-name PV changes for a 1%
# relative move, assigned to numbered buckets (equity: market-cap x
# region x sector, 12 buckets; commodity: 17 product buckets). Within a
# bucket every distinct name correlates at one scalar rho_b; across
# buckets the S_b totals correlate through a gamma matrix; names that
# fit no bucket go to the RESIDUAL bucket, whose K adds OUTSIDE the
# cross-bucket square root (no diversification against classified
# risk). Weights/correlations below are representative of the
# published calibrations (exact tables are versioned + licensed).

RESIDUAL = "Residual"

EQUITY_RISK_WEIGHTS = (
    25.0, 32.0, 29.0, 27.0, 18.0, 21.0, 24.0, 21.0, 33.0, 34.0, 17.0, 17.0
)
EQUITY_INTRA_RHO = (
    0.14, 0.20, 0.19, 0.21, 0.24, 0.35, 0.34, 0.34, 0.20, 0.24, 0.62, 0.62
)
EQUITY_CROSS_GAMMA = 0.15
EQUITY_RESIDUAL_RW = max(EQUITY_RISK_WEIGHTS)

COMMODITY_RISK_WEIGHTS = (
    19.0, 20.0, 17.0, 18.0, 24.0, 20.0, 24.0, 41.0, 25.0, 91.0,
    20.0, 19.0, 16.0, 15.0, 10.0, 74.0, 16.0
)
COMMODITY_INTRA_RHO = (
    0.30, 0.97, 0.93, 0.97, 0.98, 0.90, 0.98, 0.60, 0.65, 0.55,
    0.93, 0.91, 0.89, 0.97, 0.21, 0.19, 0.99
)
COMMODITY_CROSS_GAMMA = 0.20


def _scalar_bucket_k(ws: np.ndarray, rho: float) -> float:
    """K_b for one bucket of weighted per-name sensitivities under a
    single intra-bucket correlation:
    K^2 = sum WS_i^2 + rho * sum_{i!=j} WS_i WS_j."""
    own = float(np.dot(ws, ws))
    cross = float(ws.sum() ** 2 - own)
    return math.sqrt(max(own + rho * cross, 0.0))


def _classed_margin(
    sensitivities: dict,
    n_buckets: int,
    bucket_ks,
    cross_gamma: float,
    residual_ks,
) -> float:
    """Shared bucket-walk + tail aggregation for every classed risk
    family (Equity/Commodity scalar buckets AND the credit CS01
    classes): per bucket `bucket_ks(bucket, entries) -> (K_b, S_b)`,
    then M = sqrt( sum_b K_b^2 + gamma * sum_{b!=c} S_b S_c )
    + K_residual. Fixed iteration order (sorted buckets; callees sort
    names) keeps the float64 op order shared between the agreeing
    parties. Unknown bucket numbers raise — a misfiled name must not
    silently drop; classes without a residual bucket pass
    residual_ks=None and RESIDUAL raises too."""
    ks: list[float] = []
    ss: list[float] = []
    k_residual = 0.0
    for bucket in sorted(
        sensitivities, key=lambda b: (isinstance(b, str), b)
    ):
        entries = sensitivities[bucket]
        if not entries:
            continue
        if bucket == RESIDUAL and residual_ks is not None:
            k_residual, _ = residual_ks(entries)
            continue
        if not isinstance(bucket, int) or not (1 <= bucket <= n_buckets):
            raise ValueError(f"unknown bucket {bucket!r}")
        k, s = bucket_ks(bucket, entries)
        ks.append(k)
        ss.append(s)
    if not ks and k_residual == 0.0:
        return 0.0
    kv = np.asarray(ks, dtype=np.float64)
    sv = np.asarray(ss, dtype=np.float64)
    inner = float(np.dot(kv, kv))
    cross = float(sv.sum() ** 2 - np.dot(sv, sv))
    return math.sqrt(max(inner + cross_gamma * cross, 0.0)) + k_residual


def _scalar_bucket_ks(names: dict, rw: float, rho: float):
    """(K_b, S_b) for one Equity/Commodity bucket of {name: s}."""
    s = np.asarray(
        [float(names[n]) for n in sorted(names)], dtype=np.float64
    )
    ws = s * rw
    k = _scalar_bucket_k(ws, rho)
    return k, max(min(float(ws.sum()), k), -k)


def equity_margin(sensitivities: dict) -> float:
    """Equity delta margin over {bucket: {issuer: PV change per +1%
    relative equity move}}; buckets 1-12 (market cap x region x
    sector; 11 = indexes/funds, 12 = volatility indexes) plus
    RESIDUAL."""
    return _classed_margin(
        sensitivities,
        len(EQUITY_RISK_WEIGHTS),
        lambda b, names: _scalar_bucket_ks(
            names, EQUITY_RISK_WEIGHTS[b - 1], EQUITY_INTRA_RHO[b - 1]
        ),
        EQUITY_CROSS_GAMMA,
        lambda names: _scalar_bucket_ks(names, EQUITY_RESIDUAL_RW, 0.0),
    )


# equity vega: the published SIMM gives every risk class a vega layer
# with one scalar class VRW over the same bucket structure/correlations
# as delta, and a curvature layer fed by SF(expiry)-scaled vega
EQUITY_VEGA_RISK_WEIGHT = 0.28


def equity_vega_margin(vega_sensitivities: dict) -> float:
    """Equity vega margin over {bucket: {issuer: PV change per +1
    vol-point move}}: delta's bucket structure with the scalar equity
    VRW (mirrors the IR class, where vega shares the delta
    correlations under `VEGA_RISK_WEIGHT`)."""
    return _classed_margin(
        vega_sensitivities,
        len(EQUITY_RISK_WEIGHTS),
        lambda b, names: _scalar_bucket_ks(
            names, EQUITY_VEGA_RISK_WEIGHT, EQUITY_INTRA_RHO[b - 1]
        ),
        EQUITY_CROSS_GAMMA,
        lambda names: _scalar_bucket_ks(names, EQUITY_VEGA_RISK_WEIGHT, 0.0),
    )


def equity_curvature_margin(cvr_sensitivities: dict) -> float:
    """Equity curvature over {bucket: {issuer: CVR}} where
    CVR = SF(expiry) * vega (`scaling_function`): the published
    curvature aggregation — squared correlations, lambda/theta tail
    factor, zero floor — applied to the equity bucket structure.
    Mirrors `curvature_margin` (IR), which runs the same formula over
    the tenor grid."""
    total = 0.0
    abs_total = 0.0
    for names in cvr_sensitivities.values():
        for v in names.values():
            total += float(v)
            abs_total += abs(float(v))
    # aggregate FIRST: the bucket walk validates bucket numbers, and a
    # misfiled name must raise even while its CVR happens to be zero
    agg = _classed_margin(
        cvr_sensitivities,
        len(EQUITY_RISK_WEIGHTS),
        lambda b, names: _scalar_bucket_ks(
            names, 1.0, EQUITY_INTRA_RHO[b - 1] ** 2
        ),
        EQUITY_CROSS_GAMMA * EQUITY_CROSS_GAMMA,
        lambda names: _scalar_bucket_ks(names, 1.0, 0.0),
    )
    if abs_total == 0.0:
        return 0.0
    theta = min(total / abs_total, 0.0)
    lam = (PHI_INV_995 * PHI_INV_995 - 1.0) * (1.0 + theta) - theta
    return max(total + lam * agg, 0.0)


def commodity_margin(sensitivities: dict) -> float:
    """Commodity delta margin over {bucket: {commodity: PV change per
    +1% relative price move}}; 17 published product buckets (16 =
    "other" — the published model has NO commodity residual bucket, so
    RESIDUAL raises here like any other unknown bucket)."""
    return _classed_margin(
        sensitivities,
        len(COMMODITY_RISK_WEIGHTS),
        lambda b, names: _scalar_bucket_ks(
            names, COMMODITY_RISK_WEIGHTS[b - 1], COMMODITY_INTRA_RHO[b - 1]
        ),
        COMMODITY_CROSS_GAMMA,
        None,
    )


# ---------------------------------------------------------------------------
# CreditQ / CreditNonQ: per-(issuer, tenor) CS01 classes
#
# Sensitivities are CS01 ladders on the five published credit vertices
# per issuer, bucketed by quality x region (CreditQ, 12 buckets) or
# rating band (CreditNonQ, 2 buckets). Correlation between entries of
# one bucket: 1 for the same (issuer, tenor), rho_same for the same
# issuer at different tenors, rho_diff across issuers; cross-bucket
# gamma is flat; residual bucket adds outside the square root.

CREDIT_TENORS_Y = (1.0, 2.0, 3.0, 5.0, 10.0)
N_CREDIT_TENORS = len(CREDIT_TENORS_Y)

CREDITQ_RISK_WEIGHTS_BP = (
    97.0, 110.0, 73.0, 65.0, 52.0, 39.0, 198.0, 187.0, 110.0, 66.0,
    67.0, 74.0
)
CREDITQ_RHO_SAME = 0.93
CREDITQ_RHO_DIFF = 0.42
CREDITQ_CROSS_GAMMA = 0.42
CREDITQ_RESIDUAL_RW = max(CREDITQ_RISK_WEIGHTS_BP)

CREDITNONQ_RISK_WEIGHTS_BP = (169.0, 646.0)
CREDITNONQ_RHO_SAME = 0.60
CREDITNONQ_RHO_DIFF = 0.21
CREDITNONQ_CROSS_GAMMA = 0.05
CREDITNONQ_RESIDUAL_RW = max(CREDITNONQ_RISK_WEIGHTS_BP)


def credit_cs01_ladder(notional: int, years_to_maturity: float) -> np.ndarray:
    """[5] CS01-style ladder for a single-name CDS: spread DV01 split
    between the two credit vertices framing maturity (the credit
    analogue of `bucket_pv01`)."""
    return vertex_split(
        CREDIT_TENORS_Y, years_to_maturity,
        notional * years_to_maturity / 10_000.0,
    )


def _credit_bucket_k(
    ladders: dict, rw: float, rho_same: float, rho_diff: float
) -> tuple[float, float]:
    """(K_b, S_b) for one credit bucket of {issuer: [5] CS01 ladder}:
    K^2 = sum_i ( sum_t WS_it^2 + rho_same (S_i^2 - sum_t WS_it^2) )
          + rho_diff * sum_{i!=j} S_i S_j."""
    k2 = 0.0
    issuer_sums: list[float] = []
    for issuer in sorted(ladders):
        ws = np.asarray(ladders[issuer], dtype=np.float64) * rw
        if ws.shape != (N_CREDIT_TENORS,):
            raise ValueError(
                f"credit ladder for {issuer!r} must have "
                f"{N_CREDIT_TENORS} vertices, got {ws.shape}"
            )
        own = float(np.dot(ws, ws))
        si = float(ws.sum())
        k2 += own + rho_same * (si * si - own)
        issuer_sums.append(si)
    sv = np.asarray(issuer_sums, dtype=np.float64)
    k2 += rho_diff * float(sv.sum() ** 2 - np.dot(sv, sv))
    k = math.sqrt(max(k2, 0.0))
    s = max(min(float(sv.sum()), k), -k)
    return k, s


def _credit_margin(
    sensitivities: dict,
    risk_weights: tuple,
    rho_same: float,
    rho_diff: float,
    cross_gamma: float,
    residual_rw: float,
) -> float:
    """Shared CreditQ/CreditNonQ aggregation over
    {bucket_number_or_RESIDUAL: {issuer: [5] CS01 ladder}}."""
    return _classed_margin(
        sensitivities,
        len(risk_weights),
        lambda b, ladders: _credit_bucket_k(
            ladders, risk_weights[b - 1], rho_same, rho_diff
        ),
        cross_gamma,
        lambda ladders: _credit_bucket_k(
            ladders, residual_rw, rho_same, rho_diff
        ),
    )


def credit_q_margin(sensitivities: dict) -> float:
    """Qualifying-credit delta margin over
    {bucket: {issuer: [5] CS01 ladder}} (12 quality x region buckets
    plus RESIDUAL)."""
    return _credit_margin(
        sensitivities, CREDITQ_RISK_WEIGHTS_BP, CREDITQ_RHO_SAME,
        CREDITQ_RHO_DIFF, CREDITQ_CROSS_GAMMA, CREDITQ_RESIDUAL_RW,
    )


def credit_nonq_margin(sensitivities: dict) -> float:
    """Non-qualifying-credit delta margin (2 rating-band buckets plus
    RESIDUAL)."""
    return _credit_margin(
        sensitivities, CREDITNONQ_RISK_WEIGHTS_BP, CREDITNONQ_RHO_SAME,
        CREDITNONQ_RHO_DIFF, CREDITNONQ_CROSS_GAMMA,
        CREDITNONQ_RESIDUAL_RW,
    )


def product_margin(class_margins: dict[str, float]) -> float:
    """Cross-risk-class SIMM aggregation:
    SIMM = sqrt( sum_r IM_r^2 + sum_{r!=s} psi_rs IM_r IM_s ) over the
    six published risk classes (unknown class names raise — a typo must
    not silently drop a margin contribution)."""
    unknown = set(class_margins) - set(RISK_CLASSES)
    if unknown:
        raise ValueError(f"unknown SIMM risk class(es): {sorted(unknown)}")
    im = np.asarray(
        [float(class_margins.get(c, 0.0)) for c in RISK_CLASSES],
        dtype=np.float64,
    )
    q = float(im @ RISK_CLASS_PSI @ im)
    return math.sqrt(max(q, 0.0))


def simm_breakdown(
    delta_buckets: dict[str, np.ndarray],
    vega_buckets: dict[str, np.ndarray] | None = None,
    fx_deltas: dict[str, float] | None = None,
    equity: dict | None = None,
    commodity: dict | None = None,
    credit_q: dict | None = None,
    credit_nonq: dict | None = None,
    equity_vega: dict | None = None,
    equity_cvr: dict | None = None,
) -> dict[str, float]:
    """Per-layer margins for {currency: [K] ladder} IR inputs plus the
    optional FX / Equity / Commodity / CreditQ / CreditNonQ classes.
    The IR risk-class margin is DeltaMargin + VegaMargin +
    CurvatureMargin (the published SIMM sums the three within a risk
    class); `total` is the cross-risk-class psi aggregation over every
    class with exposure — with IR-only input it equals the IR margin,
    so IR-only callers see the same number as before the other classes
    landed."""
    out = {
        "delta": 0.0, "vega": 0.0, "curvature": 0.0, "fx": 0.0,
        "equity": 0.0, "commodity": 0.0, "credit_q": 0.0,
        "credit_nonq": 0.0, "equity_vega": 0.0, "equity_curvature": 0.0,
    }
    if delta_buckets:
        mat = np.stack([delta_buckets[c] for c in sorted(delta_buckets)])
        out["delta"] = aggregate_margin(*bucket_margins(mat))
    if vega_buckets:
        mat = np.stack([vega_buckets[c] for c in sorted(vega_buckets)])
        out["vega"] = aggregate_margin(*vega_bucket_margins(mat))
        out["curvature"] = curvature_margin(curvature_ladders(mat))
    if fx_deltas:
        out["fx"] = fx_margin(fx_deltas)
    if equity:
        out["equity"] = equity_margin(equity)
    if equity_vega:
        out["equity_vega"] = equity_vega_margin(equity_vega)
    if equity_cvr:
        out["equity_curvature"] = equity_curvature_margin(equity_cvr)
    if commodity:
        out["commodity"] = commodity_margin(commodity)
    if credit_q:
        out["credit_q"] = credit_q_margin(credit_q)
    if credit_nonq:
        out["credit_nonq"] = credit_nonq_margin(credit_nonq)
    ir = out["delta"] + out["vega"] + out["curvature"]
    # a risk class's IM is the sum of its delta/vega/curvature layers
    eq = out["equity"] + out["equity_vega"] + out["equity_curvature"]
    out["total"] = product_margin({
        "IR": ir,
        "FX": out["fx"],
        "Equity": eq,
        "Commodity": out["commodity"],
        "CreditQ": out["credit_q"],
        "CreditNonQ": out["credit_nonq"],
    })
    return out


def simm_im(
    delta_buckets: dict[str, np.ndarray],
    vega_buckets: dict[str, np.ndarray] | None = None,
    fx_deltas: dict[str, float] | None = None,
    equity: dict | None = None,
    commodity: dict | None = None,
    credit_q: dict | None = None,
    credit_nonq: dict | None = None,
    equity_vega: dict | None = None,
    equity_cvr: dict | None = None,
) -> int:
    """Initial margin for {currency: [K] sensitivity ladder} IR inputs
    (delta, optionally vega — curvature follows from vega — and
    optionally FX spot / equity (delta + vega/curvature) / commodity /
    credit sensitivities), rounded to an integer ledger amount (both
    parties must agree bit-for-bit; every float op above has a fixed
    order, so IEEE-754 doubles give one answer on any host)."""
    return int(round(simm_breakdown(
        delta_buckets, vega_buckets, fx_deltas, equity, commodity,
        credit_q, credit_nonq, equity_vega, equity_cvr,
    )["total"]))
