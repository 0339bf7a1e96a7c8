/* Third-party interop shim: drive libavcodec's independent ALAC codec
 * (FFmpeg, an implementation written from the same public spec/code drop
 * as ours but sharing no code with this repo) from the test suite.
 *
 * Purpose (SURVEY.md §4 item 4): with
 * /root/reference an empty mount, bit-exact parity against the real
 * reference binary is unprovable — an independent decoder accepting our
 * streams losslessly, and our decoder accepting an independent
 * encoder's streams, is the strongest available stand-in.
 *
 * Test-only code: built lazily by tests/test_ffmpeg_interop.py with
 *   gcc -O2 -shared -fPIC alac_ff.c -lavcodec -lavutil
 * and skipped (not failed) when libavcodec is absent.
 */

#include <stdint.h>
#include <string.h>

#include <libavcodec/avcodec.h>
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>

/* ---------------- decoder ---------------- */

typedef struct {
    AVCodecContext *ctx;
    AVPacket *pkt;
    AVFrame *frame;
} DecHandle;

void *alacff_open_decoder(const uint8_t *extradata, int extradata_size,
                          int nch, int sample_rate)
{
    const AVCodec *codec = avcodec_find_decoder(AV_CODEC_ID_ALAC);
    if (!codec)
        return NULL;
    AVCodecContext *ctx = avcodec_alloc_context3(codec);
    if (!ctx)
        return NULL;
    ctx->extradata = av_mallocz(extradata_size + AV_INPUT_BUFFER_PADDING_SIZE);
    memcpy(ctx->extradata, extradata, extradata_size);
    ctx->extradata_size = extradata_size;
    av_channel_layout_default(&ctx->ch_layout, nch);
    ctx->sample_rate = sample_rate;
    if (avcodec_open2(ctx, codec, NULL) < 0) {
        avcodec_free_context(&ctx);
        return NULL;
    }
    DecHandle *h = av_mallocz(sizeof(DecHandle));
    h->ctx = ctx;
    h->pkt = av_packet_alloc();
    h->frame = av_frame_alloc();
    return h;
}

/* Decode one packet -> planar int32 (nch x max_samples, row-major).
 * Returns the number of samples per channel, or <0 on error.
 * sample values are returned exactly as libavcodec produces them
 * (S16P widened to int32; S32P raw — the caller undoes FFmpeg's
 * MSB-justification for 20/24-bit streams). */
int alacff_decode_packet(void *handle, const uint8_t *data, int size,
                         int32_t *out, int max_samples)
{
    DecHandle *h = (DecHandle *)handle;
    int ret;
    av_packet_unref(h->pkt);
    if (av_new_packet(h->pkt, size) < 0)
        return -1000;
    memcpy(h->pkt->data, data, size);
    ret = avcodec_send_packet(h->ctx, h->pkt);
    if (ret < 0)
        return ret;
    ret = avcodec_receive_frame(h->ctx, h->frame);
    if (ret < 0)
        return ret;
    int ns = h->frame->nb_samples;
    if (ns > max_samples)
        return -1001;
    int nch = h->ctx->ch_layout.nb_channels;
    for (int c = 0; c < nch; c++) {
        int32_t *dst = out + (size_t)c * max_samples;
        if (h->frame->format == AV_SAMPLE_FMT_S16P) {
            const int16_t *src = (const int16_t *)h->frame->data[c];
            for (int i = 0; i < ns; i++)
                dst[i] = src[i];
        } else if (h->frame->format == AV_SAMPLE_FMT_S32P) {
            memcpy(dst, h->frame->data[c], (size_t)ns * 4);
        } else {
            return -1002;
        }
    }
    av_frame_unref(h->frame);
    return ns;
}

void alacff_close_decoder(void *handle)
{
    DecHandle *h = (DecHandle *)handle;
    avcodec_free_context(&h->ctx);
    av_packet_free(&h->pkt);
    av_frame_free(&h->frame);
    av_free(h);
}

/* ---------------- encoder ---------------- */

typedef struct {
    AVCodecContext *ctx;
    AVPacket *pkt;
    AVFrame *frame;
    int depth; /* 16 -> S16P, else S32P */
} EncHandle;

/* Open FFmpeg's ALAC encoder.  Writes the codec extradata (the magic
 * cookie as FFmpeg emits it) into extradata_out, its length into
 * *extradata_len (in: capacity).  Returns handle or NULL. */
void *alacff_open_encoder2(int nch, int sample_rate, int depth,
                           int frame_len, int min_order, int max_order,
                           uint8_t *extradata_out, int *extradata_len)
{
    const AVCodec *codec = avcodec_find_encoder(AV_CODEC_ID_ALAC);
    if (!codec)
        return NULL;
    AVCodecContext *ctx = avcodec_alloc_context3(codec);
    if (!ctx)
        return NULL;
    if (min_order > 0)
        av_opt_set_int(ctx, "min_prediction_order", min_order,
                       AV_OPT_SEARCH_CHILDREN);
    if (max_order > 0)
        av_opt_set_int(ctx, "max_prediction_order", max_order,
                       AV_OPT_SEARCH_CHILDREN);
    ctx->sample_fmt = depth == 16 ? AV_SAMPLE_FMT_S16P : AV_SAMPLE_FMT_S32P;
    ctx->sample_rate = sample_rate;
    /* the default layout for nch may not be in the ALAC encoder's
     * supported list (8ch default is "7.1"; the encoder wants
     * 7.1(wide)) — prefer the codec's own entry for this count */
    av_channel_layout_default(&ctx->ch_layout, nch);
    if (codec->ch_layouts) {
        for (int i = 0; codec->ch_layouts[i].nb_channels; i++) {
            if (codec->ch_layouts[i].nb_channels == nch) {
                av_channel_layout_copy(&ctx->ch_layout,
                                       &codec->ch_layouts[i]);
                break;
            }
        }
    }
    if (frame_len > 0)
        ctx->frame_size = frame_len; /* encoder may override after open */
    if (avcodec_open2(ctx, codec, NULL) < 0) {
        avcodec_free_context(&ctx);
        return NULL;
    }
    if (ctx->extradata_size > *extradata_len) {
        avcodec_free_context(&ctx);
        return NULL;
    }
    memcpy(extradata_out, ctx->extradata, ctx->extradata_size);
    *extradata_len = ctx->extradata_size;
    EncHandle *h = av_mallocz(sizeof(EncHandle));
    h->ctx = ctx;
    h->pkt = av_packet_alloc();
    h->frame = av_frame_alloc();
    h->depth = depth;
    return h;
}

void *alacff_open_encoder(int nch, int sample_rate, int depth,
                          int frame_len, uint8_t *extradata_out,
                          int *extradata_len)
{
    return alacff_open_encoder2(nch, sample_rate, depth, frame_len, 0, 0,
                                extradata_out, extradata_len);
}

int alacff_encoder_frame_size(void *handle)
{
    return ((EncHandle *)handle)->ctx->frame_size;
}

/* Send nsamples (<= frame_size; 0 = flush) of planar int32 PCM
 * (nch x nsamples, row-major, right-aligned at depth) and try to
 * receive one packet into out.  Returns packet size (0 = none yet,
 * <0 = error). */
int alacff_encode_frame(void *handle, const int32_t *pcm, int nsamples,
                        uint8_t *out, int out_cap)
{
    EncHandle *h = (EncHandle *)handle;
    int ret;
    if (nsamples > 0) {
        av_frame_unref(h->frame);
        h->frame->nb_samples = nsamples;
        h->frame->format = h->ctx->sample_fmt;
        av_channel_layout_copy(&h->frame->ch_layout, &h->ctx->ch_layout);
        if (av_frame_get_buffer(h->frame, 0) < 0)
            return -1000;
        int nch = h->ctx->ch_layout.nb_channels;
        for (int c = 0; c < nch; c++) {
            const int32_t *src = pcm + (size_t)c * nsamples;
            if (h->ctx->sample_fmt == AV_SAMPLE_FMT_S16P) {
                int16_t *dst = (int16_t *)h->frame->data[c];
                for (int i = 0; i < nsamples; i++)
                    dst[i] = (int16_t)src[i];
            } else {
                memcpy(h->frame->data[c], src, (size_t)nsamples * 4);
            }
        }
        ret = avcodec_send_frame(h->ctx, h->frame);
    } else {
        ret = avcodec_send_frame(h->ctx, NULL); /* flush */
    }
    if (ret < 0 && ret != AVERROR(EAGAIN))
        return ret;
    ret = avcodec_receive_packet(h->ctx, h->pkt);
    if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF)
        return 0;
    if (ret < 0)
        return ret;
    if (h->pkt->size > out_cap)
        return -1001;
    memcpy(out, h->pkt->data, h->pkt->size);
    int sz = h->pkt->size;
    av_packet_unref(h->pkt);
    return sz;
}

void alacff_close_encoder(void *handle)
{
    EncHandle *h = (EncHandle *)handle;
    avcodec_free_context(&h->ctx);
    av_packet_free(&h->pkt);
    av_frame_free(&h->frame);
    av_free(h);
}

/* ---------------- container-level interop (CAF) ---------------- */

#include <libavformat/avformat.h>

/* Demux + decode an ALAC .caf file via libavformat/libavcodec — the
 * third-party validation of our L4 container writer (chunk layout,
 * BER packet table, kuki cookie placement; containers/caf.py).
 * out: planar int32 (nch x max_samples, row-major).  Returns total
 * samples per channel, or <0 on error. */
int alacff_decode_caf(const char *path, int32_t *out, int max_samples,
                      int *nch_out, int *rate_out)
{
    AVFormatContext *fmt = NULL;
    AVCodecContext *ctx = NULL;
    AVPacket *pkt = NULL;
    AVFrame *frame = NULL;
    int ret = -2000, stream_idx = -1, total = 0;

    if (avformat_open_input(&fmt, path, NULL, NULL) < 0)
        return -2001;
    if (avformat_find_stream_info(fmt, NULL) < 0)
        goto done;
    for (unsigned i = 0; i < fmt->nb_streams; i++) {
        if (fmt->streams[i]->codecpar->codec_id == AV_CODEC_ID_ALAC) {
            stream_idx = (int)i;
            break;
        }
    }
    if (stream_idx < 0) {
        ret = -2002;
        goto done;
    }
    {
        const AVCodec *codec = avcodec_find_decoder(AV_CODEC_ID_ALAC);
        ctx = avcodec_alloc_context3(codec);
        if (!ctx || avcodec_parameters_to_context(
                        ctx, fmt->streams[stream_idx]->codecpar) < 0
            || avcodec_open2(ctx, codec, NULL) < 0) {
            ret = -2003;
            goto done;
        }
    }
    *nch_out = ctx->ch_layout.nb_channels;
    *rate_out = ctx->sample_rate;
    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    while (av_read_frame(fmt, pkt) >= 0) {
        if (pkt->stream_index != stream_idx) {
            av_packet_unref(pkt);
            continue;
        }
        if (avcodec_send_packet(ctx, pkt) < 0) {
            ret = -2004;
            goto done;
        }
        av_packet_unref(pkt);
        while (1) {
            int r = avcodec_receive_frame(ctx, frame);
            if (r == AVERROR(EAGAIN) || r == AVERROR_EOF)
                break;
            if (r < 0) {
                ret = -2005;
                goto done;
            }
            int ns = frame->nb_samples;
            if (total + ns > max_samples) {
                ret = -2006;
                goto done;
            }
            for (int c = 0; c < ctx->ch_layout.nb_channels; c++) {
                int32_t *dst = out + (size_t)c * max_samples + total;
                if (frame->format == AV_SAMPLE_FMT_S16P) {
                    const int16_t *src = (const int16_t *)frame->data[c];
                    for (int i = 0; i < ns; i++)
                        dst[i] = src[i];
                } else if (frame->format == AV_SAMPLE_FMT_S32P) {
                    memcpy(dst, frame->data[c], (size_t)ns * 4);
                } else {
                    ret = -2007;
                    goto done;
                }
            }
            total += ns;
            av_frame_unref(frame);
        }
    }
    ret = total;
done:
    if (frame)
        av_frame_free(&frame);
    if (pkt)
        av_packet_free(&pkt);
    if (ctx)
        avcodec_free_context(&ctx);
    if (fmt)
        avformat_close_input(&fmt);
    return ret;
}

/* Encode PCM with FFmpeg's ALAC encoder and mux it via libavformat —
 * a third-party writer whose output our container readers must parse
 * (containers/caf.py and containers/mp4.py parse legs).
 * fmt_name: libavformat muxer name ("caf", "ipod" for .m4a, ...) or
 * NULL to infer from the path suffix.
 * pcm: planar int32 (nch x n).  Returns 0 or <0. */
int alacff_encode_mux(const char *path, const char *fmt_name,
                      const int32_t *pcm, int nch, int n, int sample_rate)
{
    AVFormatContext *fmt = NULL;
    AVCodecContext *ctx = NULL;
    AVStream *st = NULL;
    AVPacket *pkt = NULL;
    AVFrame *frame = NULL;
    int ret = -3000, off = 0, header_open = 0;
    const AVCodec *codec = avcodec_find_encoder(AV_CODEC_ID_ALAC);

    if (!codec)
        return -3001;
    if (avformat_alloc_output_context2(&fmt, NULL, fmt_name, path) < 0)
        return -3002;
    ctx = avcodec_alloc_context3(codec);
    ctx->sample_fmt = AV_SAMPLE_FMT_S16P;
    ctx->sample_rate = sample_rate;
    av_channel_layout_default(&ctx->ch_layout, nch);
    if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
        ctx->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
    if (avcodec_open2(ctx, codec, NULL) < 0)
        goto done;
    st = avformat_new_stream(fmt, NULL);
    if (!st || avcodec_parameters_from_context(st->codecpar, ctx) < 0)
        goto done;
    st->time_base = (AVRational){1, sample_rate};
    if (avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
        goto done;
    if (avformat_write_header(fmt, NULL) < 0)
        goto done;
    header_open = 1;
    pkt = av_packet_alloc();
    frame = av_frame_alloc();
    while (off < n || off == n) { /* one extra loop to flush */
        int send_flush = off >= n;
        if (!send_flush) {
            int ns = n - off < ctx->frame_size ? n - off : ctx->frame_size;
            av_frame_unref(frame);
            frame->nb_samples = ns;
            frame->format = ctx->sample_fmt;
            av_channel_layout_copy(&frame->ch_layout, &ctx->ch_layout);
            if (av_frame_get_buffer(frame, 0) < 0)
                goto done;
            for (int c = 0; c < nch; c++) {
                const int32_t *src = pcm + (size_t)c * n + off;
                int16_t *dst = (int16_t *)frame->data[c];
                for (int i = 0; i < ns; i++)
                    dst[i] = (int16_t)src[i];
            }
            frame->pts = off;
            if (avcodec_send_frame(ctx, frame) < 0)
                goto done;
            off += ns;
        } else {
            avcodec_send_frame(ctx, NULL);
        }
        while (1) {
            int r = avcodec_receive_packet(ctx, pkt);
            if (r == AVERROR(EAGAIN) || r == AVERROR_EOF)
                break;
            if (r < 0)
                goto done;
            pkt->stream_index = st->index;
            if (av_interleaved_write_frame(fmt, pkt) < 0)
                goto done;
        }
        if (send_flush)
            break;
    }
    if (av_write_trailer(fmt) < 0)
        goto done;
    ret = 0;
done:
    if (frame)
        av_frame_free(&frame);
    if (pkt)
        av_packet_free(&pkt);
    if (ctx)
        avcodec_free_context(&ctx);
    if (fmt) {
        if (header_open && fmt->pb)
            avio_closep(&fmt->pb);
        avformat_free_context(fmt);
    }
    return ret;
}

int alacff_encode_caf(const char *path, const int32_t *pcm, int nch,
                      int n, int sample_rate)
{
    return alacff_encode_mux(path, "caf", pcm, nch, n, sample_rate);
}

/* alacff_decode_caf probes the container, so it demuxes any libavformat
 * input (CAF, M4A/MP4, ...); alias under the honest name. */
int alacff_decode_file(const char *path, int32_t *out, int max_samples,
                       int *nch_out, int *rate_out)
{
    return alacff_decode_caf(path, out, max_samples, nch_out, rate_out);
}
