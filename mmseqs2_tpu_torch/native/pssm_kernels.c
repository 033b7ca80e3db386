/* Native float kernels whose results depend on x86 instruction semantics
 * (rcpps approximation, fp contraction) and therefore cannot be reproduced
 * bit-exactly in pure numpy.
 *
 * Parity targets in the reference:
 *  - PSSMCalculator::computeContextSpecificWeights weight contributions
 *    (src/alignment/PSSMCalculator.cpp): w = 2*rcp(x) - x*rcp(x)^2 with
 *    rcp = _mm_rcp_ps (approximate reciprocal + one Newton-Raphson step).
 *  - PSSMCalculator::preparePseudoCounts ScalarProd20 (lib/simd/simd.h):
 *    a 20-float dot product with a fixed SSE lane/reduction tree; compiled
 *    with the same -O3 -march=native contraction behavior.
 *
 * Build: cc -O3 -march=native -fsigned-char -shared -fPIC
 */

#include <immintrin.h>

/* out[i] = NewtonRaphson(rcp(in[i])) elementwise; in[i] > 0 expected. */
void nr_rcp_batch(const float *in, float *out, long n) {
    long i = 0;
    for (; i + 4 <= n; i += 4) {
        __m128 x = _mm_loadu_ps(in + i);
        __m128 r = _mm_rcp_ps(x);
        __m128 muls = _mm_mul_ps(x, _mm_mul_ps(r, r));
        _mm_storeu_ps(out + i, _mm_sub_ps(_mm_add_ps(r, r), muls));
    }
    for (; i < n; i++) {
        __m128 x = _mm_set1_ps(in[i]);
        __m128 r = _mm_rcp_ps(x);
        __m128 muls = _mm_mul_ps(x, _mm_mul_ps(r, r));
        __m128 res = _mm_sub_ps(_mm_add_ps(r, r), muls);
        out[i] = _mm_cvtss_f32(res);
    }
}

/* 20-float dot product with the reference's SSE reduction tree. */
static float scalar_prod20(const float *qi, const float *tj) {
    float res;
    __m128 P;
    __m128 R;

    __m128 P1 = _mm_mul_ps(_mm_loadu_ps(qi), _mm_loadu_ps(tj));
    __m128 P2 = _mm_mul_ps(_mm_loadu_ps(qi + 4), _mm_loadu_ps(tj + 4));
    __m128 R1 = _mm_add_ps(P1, P2);

    __m128 P3 = _mm_mul_ps(_mm_loadu_ps(qi + 8), _mm_loadu_ps(tj + 8));
    __m128 P4 = _mm_mul_ps(_mm_loadu_ps(qi + 12), _mm_loadu_ps(tj + 12));
    __m128 R2 = _mm_add_ps(P3, P4);
    __m128 P5 = _mm_mul_ps(_mm_loadu_ps(qi + 16), _mm_loadu_ps(tj + 16));

    R = _mm_add_ps(R1, R2);
    R = _mm_add_ps(R, P5);
    P = _mm_shuffle_ps(R, R, _MM_SHUFFLE(2, 0, 2, 0));
    R = _mm_shuffle_ps(R, R, _MM_SHUFFLE(3, 1, 3, 1));
    R = _mm_add_ps(R, P);
    P = _mm_shuffle_ps(R, R, _MM_SHUFFLE(2, 0, 2, 0));
    R = _mm_shuffle_ps(R, R, _MM_SHUFFLE(3, 1, 3, 1));
    R = _mm_add_ps(R, P);
    _mm_store_ss(&res, R);
    return res;
}

/* out[p][aa] = ScalarProd20(R20[aa], freq[p]); R20 (20,20), freq (n_pos,20).
 * Rows must be 16-byte aligned (numpy default allocations are). */
void scalar_prod20_batch(const float *R20, const float *freq, float *out,
                         long n_pos) {
    for (long p = 0; p < n_pos; p++) {
        for (int aa = 0; aa < 20; aa++) {
            out[p * 20 + aa] = scalar_prod20(R20 + aa * 20, freq + p * 20);
        }
    }
}
