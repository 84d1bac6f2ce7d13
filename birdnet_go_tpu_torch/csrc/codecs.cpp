// Native lossy audio codecs for clip export and streaming: the PyTorch
// port's own copy of native/codecs.cpp, built into its own library
// (birdnet_go_tpu_torch/native/lib.py, build_codecs) with g++ -ldl and no
// codec header.
//
// Opus (libopus) and MP3 (libmp3lame) are native/codecs.cpp's, unchanged:
// the libraries are dlopen'd and every entry point reports unavailable
// when one is missing. AAC-LC reaches libavcodec the same way but needs
// none of FFmpeg's headers (see the AAC section below).
//
// C ABI only — consumed from Python via ctypes.
//
// Packet framing: encoders emit a stream of length-prefixed packets
// [u32 LE length][payload]… so Python can mux containers (Ogg Opus) without
// callbacks across the FFI boundary.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <vector>

#include <dlfcn.h>

#define BN_API extern "C" __attribute__((visibility("default")))

// ---------------------------------------------------------------------------
// libopus via dlopen
// ---------------------------------------------------------------------------

// Constants from opus_defines.h (stable public ABI).
static const int OPUS_APPLICATION_AUDIO = 2049;
static const int OPUS_SET_BITRATE_REQUEST = 4002;
static const int OPUS_SET_COMPLEXITY_REQUEST = 4010;
static const int OPUS_GET_LOOKAHEAD_REQUEST = 4027;

typedef void* (*opus_enc_create_fn)(int32_t, int, int, int*);
typedef int (*opus_enc_ctl_fn)(void*, int, ...);
typedef int32_t (*opus_encode_fn)(void*, const int16_t*, int,
                                  unsigned char*, int32_t);
typedef void (*opus_enc_destroy_fn)(void*);
typedef void* (*opus_dec_create_fn)(int32_t, int, int*);
typedef int (*opus_decode_fn)(void*, const unsigned char*, int32_t,
                              int16_t*, int, int);
typedef void (*opus_dec_destroy_fn)(void*);

struct OpusLib {
    void* handle = nullptr;
    bool tried = false;
    opus_enc_create_fn enc_create = nullptr;
    opus_enc_ctl_fn enc_ctl = nullptr;
    opus_encode_fn encode = nullptr;
    opus_enc_destroy_fn enc_destroy = nullptr;
    opus_dec_create_fn dec_create = nullptr;
    opus_decode_fn decode = nullptr;
    opus_dec_destroy_fn dec_destroy = nullptr;
    std::mutex mu;
};

static OpusLib& opuslib() {
    static OpusLib l;
    std::lock_guard<std::mutex> g(l.mu);
    if (!l.tried) {
        l.tried = true;
        l.handle = dlopen("libopus.so.0", RTLD_NOW | RTLD_LOCAL);
        if (!l.handle) l.handle = dlopen("libopus.so", RTLD_NOW | RTLD_LOCAL);
        if (l.handle) {
            l.enc_create = (opus_enc_create_fn)dlsym(l.handle,
                                                     "opus_encoder_create");
            l.enc_ctl = (opus_enc_ctl_fn)dlsym(l.handle, "opus_encoder_ctl");
            l.encode = (opus_encode_fn)dlsym(l.handle, "opus_encode");
            l.enc_destroy = (opus_enc_destroy_fn)dlsym(l.handle,
                                                       "opus_encoder_destroy");
            l.dec_create = (opus_dec_create_fn)dlsym(l.handle,
                                                     "opus_decoder_create");
            l.decode = (opus_decode_fn)dlsym(l.handle, "opus_decode");
            l.dec_destroy = (opus_dec_destroy_fn)dlsym(l.handle,
                                                       "opus_decoder_destroy");
            if (!l.enc_create || !l.enc_ctl || !l.encode || !l.enc_destroy ||
                !l.dec_create || !l.decode || !l.dec_destroy) {
                dlclose(l.handle);
                l.handle = nullptr;
            }
        }
    }
    return l;
}

BN_API int bn_opus_available() { return opuslib().handle ? 1 : 0; }

// Encode mono/stereo int16 PCM into length-prefixed Opus packets.
//  pcm       : interleaved int16, n_frames per channel
//  rate      : 8000/12000/16000/24000/48000 (Opus-valid rates only)
//  bitrate   : target bits/s (e.g. 64000)
//  out       : caller buffer for [u32 len][packet]... frames
//  preskip   : out — encoder lookahead in samples at `rate`
//  n_packets : out — number of packets written
// Returns bytes written to out, -1 unavailable, -2 bad args, -3 out full,
// -4 encoder error.
BN_API int64_t bn_opus_encode(const int16_t* pcm, int64_t n_frames, int rate,
                              int channels, int bitrate, unsigned char* out,
                              int64_t out_cap, int32_t* n_packets,
                              int32_t* preskip) {
    OpusLib& l = opuslib();
    if (!l.handle) return -1;
    if (!pcm || n_frames <= 0 || (channels != 1 && channels != 2)) return -2;
    if (rate != 8000 && rate != 12000 && rate != 16000 && rate != 24000 &&
        rate != 48000) return -2;
    int err = 0;
    void* enc = l.enc_create(rate, channels, OPUS_APPLICATION_AUDIO, &err);
    if (!enc || err != 0) return -4;
    l.enc_ctl(enc, OPUS_SET_BITRATE_REQUEST, (int32_t)bitrate);
    l.enc_ctl(enc, OPUS_SET_COMPLEXITY_REQUEST, (int32_t)8);
    int32_t look = 0;
    l.enc_ctl(enc, OPUS_GET_LOOKAHEAD_REQUEST, &look);
    if (preskip) *preskip = look;

    const int frame = rate / 50;              // 20 ms frames
    unsigned char pkt[4000];                  // max recommended packet size
    int64_t written = 0;
    int32_t packets = 0;
    // zero-padded tail frame keeps total sample accounting simple: the
    // muxer trims via Ogg granule positions (audiocore/opus/encode.go role)
    std::vector<int16_t> scratch((size_t)frame * channels);
    for (int64_t off = 0; off < n_frames; off += frame) {
        const int16_t* src;
        int64_t have = n_frames - off;
        if (have >= frame) {
            src = pcm + off * channels;
        } else {
            std::memset(scratch.data(), 0, scratch.size() * sizeof(int16_t));
            std::memcpy(scratch.data(), pcm + off * channels,
                        (size_t)have * channels * sizeof(int16_t));
            src = scratch.data();
        }
        int32_t n = l.encode(enc, src, frame, pkt, (int32_t)sizeof(pkt));
        if (n < 0) { l.enc_destroy(enc); return -4; }
        if (written + 4 + n > out_cap) { l.enc_destroy(enc); return -3; }
        out[written + 0] = (unsigned char)(n & 0xff);
        out[written + 1] = (unsigned char)((n >> 8) & 0xff);
        out[written + 2] = (unsigned char)((n >> 16) & 0xff);
        out[written + 3] = (unsigned char)((n >> 24) & 0xff);
        std::memcpy(out + written + 4, pkt, (size_t)n);
        written += 4 + n;
        packets++;
    }
    l.enc_destroy(enc);
    if (n_packets) *n_packets = packets;
    return written;
}

// Decode length-prefixed Opus packets back to interleaved int16 PCM.
// Returns frames (per channel) written, or negative error.
BN_API int64_t bn_opus_decode(const unsigned char* packets,
                              int64_t packets_len, int rate, int channels,
                              int16_t* out, int64_t out_cap_frames) {
    OpusLib& l = opuslib();
    if (!l.handle) return -1;
    if (!packets || (channels != 1 && channels != 2)) return -2;
    int err = 0;
    void* dec = l.dec_create(rate, channels, &err);
    if (!dec || err != 0) return -4;
    const int max_frame = rate * 60 / 1000;   // max 60 ms packets
    int64_t frames = 0;
    int64_t off = 0;
    while (off + 4 <= packets_len) {
        uint32_t n = (uint32_t)packets[off] | ((uint32_t)packets[off + 1] << 8)
            | ((uint32_t)packets[off + 2] << 16)
            | ((uint32_t)packets[off + 3] << 24);
        off += 4;
        if (off + (int64_t)n > packets_len) break;
        if (frames + max_frame > out_cap_frames) { l.dec_destroy(dec); return -3; }
        int got = l.decode(dec, packets + off, (int32_t)n,
                           out + frames * channels, max_frame, 0);
        if (got < 0) { l.dec_destroy(dec); return -4; }
        frames += got;
        off += n;
    }
    l.dec_destroy(dec);
    return frames;
}

// ---------------------------------------------------------------------------
// Streaming Opus encoder: persistent state across chunks so a live HTTP
// stream has no per-chunk lookahead resets (no clicks at chunk joins).
// Partial 20 ms frames carry over inside the handle.
// ---------------------------------------------------------------------------

struct OpusStream {
    void* enc;
    int rate;
    int channels;
    std::vector<int16_t> carry;   // < one frame of samples (interleaved)
};

BN_API void* bn_opus_stream_create(int rate, int channels, int bitrate,
                                   int32_t* preskip) {
    OpusLib& l = opuslib();
    if (!l.handle) return nullptr;
    if ((channels != 1 && channels != 2) ||
        (rate != 8000 && rate != 12000 && rate != 16000 && rate != 24000 &&
         rate != 48000)) return nullptr;
    int err = 0;
    void* enc = l.enc_create(rate, channels, OPUS_APPLICATION_AUDIO, &err);
    if (!enc || err != 0) return nullptr;
    l.enc_ctl(enc, OPUS_SET_BITRATE_REQUEST, (int32_t)bitrate);
    l.enc_ctl(enc, OPUS_SET_COMPLEXITY_REQUEST, (int32_t)6);
    int32_t look = 0;
    l.enc_ctl(enc, OPUS_GET_LOOKAHEAD_REQUEST, &look);
    if (preskip) *preskip = look;
    auto* s = new OpusStream{enc, rate, channels, {}};
    return s;
}

// Feed PCM; emits length-prefixed packets for every complete 20 ms frame.
// Returns bytes written to out (0 when not enough audio yet), or negative
// error like bn_opus_encode.
BN_API int64_t bn_opus_stream_encode(void* handle, const int16_t* pcm,
                                     int64_t n_frames, unsigned char* out,
                                     int64_t out_cap, int32_t* n_packets) {
    OpusLib& l = opuslib();
    auto* s = (OpusStream*)handle;
    if (!s || !l.handle) return -1;
    if (n_frames < 0) return -2;
    const int frame = s->rate / 50;
    s->carry.insert(s->carry.end(), pcm,
                    pcm + (size_t)n_frames * s->channels);
    unsigned char pkt[4000];
    int64_t written = 0;
    int32_t packets = 0;
    size_t off = 0;
    const size_t frame_sz = (size_t)frame * s->channels;
    while (s->carry.size() - off >= frame_sz) {
        // capacity precheck BEFORE encoding: once l.encode runs, the
        // encoder's predictive state has consumed the frame, so bailing
        // out afterwards would either duplicate it (carry kept) or glitch
        // (packet dropped). Unencoded frames stay in carry for next call;
        // callers size out_cap >= 16 KiB so this never fires in practice.
        if (out_cap - written < 4 + (int64_t)sizeof(pkt)) break;
        int32_t n = l.encode(s->enc, s->carry.data() + off, frame, pkt,
                             (int32_t)sizeof(pkt));
        if (n < 0) { s->carry.erase(s->carry.begin(),
                                    s->carry.begin() + (long)off);
                     return -4; }
        out[written + 0] = (unsigned char)(n & 0xff);
        out[written + 1] = (unsigned char)((n >> 8) & 0xff);
        out[written + 2] = (unsigned char)((n >> 16) & 0xff);
        out[written + 3] = (unsigned char)((n >> 24) & 0xff);
        std::memcpy(out + written + 4, pkt, (size_t)n);
        written += 4 + n;
        packets++;
        off += frame_sz;
    }
    s->carry.erase(s->carry.begin(), s->carry.begin() + (long)off);
    if (n_packets) *n_packets = packets;
    return written;
}

BN_API void bn_opus_stream_destroy(void* handle) {
    auto* s = (OpusStream*)handle;
    if (!s) return;
    opuslib().enc_destroy(s->enc);
    delete s;
}

// ---------------------------------------------------------------------------
// libmp3lame via dlopen
// ---------------------------------------------------------------------------

typedef void* (*lame_init_fn)();
typedef int (*lame_set_i_fn)(void*, int);
typedef int (*lame_init_params_fn)(void*);
typedef int (*lame_enc_buf_fn)(void*, const int16_t*, const int16_t*, int,
                               unsigned char*, int);
typedef int (*lame_enc_interleaved_fn)(void*, int16_t*, int, unsigned char*,
                                       int);
typedef int (*lame_flush_fn)(void*, unsigned char*, int);
typedef int (*lame_close_fn)(void*);

struct LameLib {
    void* handle = nullptr;
    bool tried = false;
    lame_init_fn init = nullptr;
    lame_set_i_fn set_in_samplerate = nullptr;
    lame_set_i_fn set_num_channels = nullptr;
    lame_set_i_fn set_brate = nullptr;
    lame_set_i_fn set_quality = nullptr;
    lame_init_params_fn init_params = nullptr;
    lame_enc_buf_fn encode_buffer = nullptr;
    lame_enc_interleaved_fn encode_interleaved = nullptr;
    lame_flush_fn flush = nullptr;
    lame_close_fn close = nullptr;
    std::mutex mu;
};

static LameLib& lamelib() {
    static LameLib l;
    std::lock_guard<std::mutex> g(l.mu);
    if (!l.tried) {
        l.tried = true;
        l.handle = dlopen("libmp3lame.so.0", RTLD_NOW | RTLD_LOCAL);
        if (!l.handle)
            l.handle = dlopen("libmp3lame.so", RTLD_NOW | RTLD_LOCAL);
        if (l.handle) {
            l.init = (lame_init_fn)dlsym(l.handle, "lame_init");
            l.set_in_samplerate =
                (lame_set_i_fn)dlsym(l.handle, "lame_set_in_samplerate");
            l.set_num_channels =
                (lame_set_i_fn)dlsym(l.handle, "lame_set_num_channels");
            l.set_brate = (lame_set_i_fn)dlsym(l.handle, "lame_set_brate");
            l.set_quality = (lame_set_i_fn)dlsym(l.handle, "lame_set_quality");
            l.init_params =
                (lame_init_params_fn)dlsym(l.handle, "lame_init_params");
            l.encode_buffer =
                (lame_enc_buf_fn)dlsym(l.handle, "lame_encode_buffer");
            l.encode_interleaved = (lame_enc_interleaved_fn)dlsym(
                l.handle, "lame_encode_buffer_interleaved");
            l.flush = (lame_flush_fn)dlsym(l.handle, "lame_encode_flush");
            l.close = (lame_close_fn)dlsym(l.handle, "lame_close");
            if (!l.init || !l.set_in_samplerate || !l.set_num_channels ||
                !l.set_brate || !l.set_quality || !l.init_params ||
                !l.encode_buffer || !l.flush || !l.close) {
                dlclose(l.handle);
                l.handle = nullptr;
            }
        }
    }
    return l;
}

BN_API int bn_mp3_available() { return lamelib().handle ? 1 : 0; }

// Encode int16 PCM to a complete MP3 stream. Returns bytes written,
// -1 unavailable, -2 bad args, -3 out full, -4 encoder error.
BN_API int64_t bn_mp3_encode(const int16_t* pcm, int64_t n_frames, int rate,
                             int channels, int bitrate_kbps,
                             unsigned char* out, int64_t out_cap) {
    LameLib& l = lamelib();
    if (!l.handle) return -1;
    if (!pcm || n_frames <= 0 || (channels != 1 && channels != 2)) return -2;
    void* gfp = l.init();
    if (!gfp) return -4;
    l.set_in_samplerate(gfp, rate);
    l.set_num_channels(gfp, channels);
    l.set_brate(gfp, bitrate_kbps);
    l.set_quality(gfp, 2);
    if (l.init_params(gfp) < 0) { l.close(gfp); return -4; }
    int64_t written = 0;
    const int chunk = 4608;                   // multiple of MP3 granule
    for (int64_t off = 0; off < n_frames; off += chunk) {
        int n = (int)((n_frames - off) < chunk ? (n_frames - off) : chunk);
        int cap = (int)(out_cap - written);
        if (cap <= 0) { l.close(gfp); return -3; }
        int got;
        if (channels == 1) {
            got = l.encode_buffer(gfp, pcm + off, nullptr, n,
                                  out + written, cap);
        } else if (l.encode_interleaved) {
            got = l.encode_interleaved(gfp, (int16_t*)(pcm + off * 2), n,
                                       out + written, cap);
        } else {
            l.close(gfp);
            return -4;
        }
        if (got < 0) { l.close(gfp); return got == -1 ? -3 : -4; }
        written += got;
    }
    int cap = (int)(out_cap - written);
    int got = l.flush(gfp, out + written, cap > 0 ? cap : 0);
    if (got < 0) { l.close(gfp); return -3; }
    written += got;
    l.close(gfp);
    return written;
}


// ---------------------------------------------------------------------------
// AAC-LC via dlopen'd libavcodec (FFmpeg's native aac encoder/decoder),
// with no FFmpeg header.
//
// native/codecs.cpp includes FFmpeg's headers for the layout of
// AVCodecContext, AVFrame and AVPacket; a machine without them cannot build
// it. Here only functions are resolved, by dlsym, and:
// - the codec context is set through AVOptions ("ar", "b", "ch_layout" —
//   "ac" and "channel_layout" before libavcodec 59.24 — "profile",
//   "flags") and its frame size read back with av_opt_get_int; the one
//   field no option sets, sample_fmt, is found beside frame_size from the
//   options' own offsets and checked before it is written
//   (set_sample_fmt_fltp);
// - of AVPacket only the leading buf, pts, dts, data and size are touched,
//   and of AVFrame the leading data[], nb_samples and format: the same
//   from libavcodec 58 / libavutil 56 to libavcodec 61 / libavutil 59;
// - the encoder's input frame is a frame the decoder made (one silent
//   ADTS frame decoded at the stream's rate and channels), so libavutil
//   itself sets its channel layout, rate and format; each chunk is written
//   into it after av_frame_make_writable;
// - the AudioSpecificConfig is built from the rate index and the channel
//   count as FFmpeg's encoder writes its extradata (LC, then the sync
//   extension that marks SBR absent: 5 bytes), and the priming is the
//   encoder's documented 1024 samples (its initial_padding);
// - the decoder is fed ADTS-framed access units, so it needs no
//   extradata and no channel layout.
// avcodec_version()'s major is checked at load (58 to 61 accepted);
// verified: 59 (FFmpeg 5.1).
// ---------------------------------------------------------------------------

struct AvPacketHead {               // AVPacket's leading fields
    void* buf;
    int64_t pts;
    int64_t dts;
    uint8_t* data;
    int size;
};

struct AvOptionHead {               // AVOption's leading fields
    const char* name;
    const char* help;
    int offset;
};

struct AvFrameHead {                // AVFrame's leading fields
    uint8_t* data[8];
    int linesize[8];
    uint8_t** extended_data;
    int width;
    int height;
    int nb_samples;
    int format;
};

static const int kSampleFmtFltp = 8;          // AV_SAMPLE_FMT_FLTP
static const int kProfileAacLow = 1;          // FF_PROFILE_AAC_LOW
static const int kLogError = 16;              // AV_LOG_ERROR
static const int kInputPadding = 64;          // AV_INPUT_BUFFER_PADDING_SIZE
static const int kErrorEagain = -EAGAIN;      // AVERROR(EAGAIN)
static const int kErrorEof =                  // AVERROR_EOF
    -(int)('E' | ('O' << 8) | ('F' << 16) | ((unsigned)' ' << 24));
static const int kAacFrame = 1024;
static const int kAacPriming = 1024;          // the encoder's initial_padding

// ADTS / AudioSpecificConfig sampling-frequency index (ISO 14496-3 1.6.3.4)
static int aac_freq_index(int rate) {
    static const int rates[13] = {96000, 88200, 64000, 48000, 44100, 32000,
                                  24000, 22050, 16000, 12000, 11025, 8000,
                                  7350};
    for (int i = 0; i < 13; ++i)
        if (rates[i] == rate) return i;
    return -1;
}

struct BitWriter {
    std::vector<uint8_t> out;
    int bits = 0;
    void put(uint32_t v, int n) {
        for (int i = n - 1; i >= 0; --i) {
            if (bits % 8 == 0) out.push_back(0);
            if ((v >> i) & 1) out.back() |= (uint8_t)(0x80 >> (bits % 8));
            ++bits;
        }
    }
};

static std::vector<uint8_t> adts_header(int aot, int freq_index,
                                        int channels, int payload) {
    const int ln = payload + 7;
    return {0xFF, 0xF1,                       // sync, MPEG-4, no CRC
            (uint8_t)(((aot - 1) << 6) | (freq_index << 2)
                      | ((channels >> 2) & 1)),
            (uint8_t)(((channels & 3) << 6) | ((ln >> 11) & 0x3)),
            (uint8_t)((ln >> 3) & 0xFF),
            (uint8_t)(((ln & 0x7) << 5) | 0x1F),   // fullness 0x7FF
            0xFC};                                 // one raw data block
}

// One silent raw_data_block: an SCE (mono) or a CPE without a common
// window (stereo) whose channels code no band (max_sfb 0), then END.
static std::vector<uint8_t> silent_block(int channels) {
    BitWriter w;
    w.put(channels == 1 ? 0 : 1, 3);          // ID_SCE / ID_CPE
    w.put(0, 4);                              // element_instance_tag
    if (channels == 2) w.put(0, 1);           // common_window
    for (int c = 0; c < channels; ++c) {
        w.put(0, 8);                          // global_gain
        w.put(0, 1);                          // ics_reserved_bit
        w.put(0, 2);                          // ONLY_LONG_SEQUENCE
        w.put(0, 1);                          // window_shape
        w.put(0, 6);                          // max_sfb
        w.put(0, 1);                          // predictor_data_present
        w.put(0, 3);                          // pulse, tns, gain control
    }
    w.put(7, 3);                              // ID_END
    return w.out;
}

typedef unsigned (*av_version_fn)();
typedef const void* (*av_find_fn)(const char*);
typedef void* (*av_alloc_context_fn)(const void*);
typedef void (*av_free_ptr_fn)(void**);
typedef int (*av_open2_fn)(void*, const void*, void**);
typedef int (*av_send_fn)(void*, const void*);
typedef int (*av_receive_fn)(void*, void*);
typedef void* (*av_alloc_fn)();
typedef void (*av_unref_fn)(void*);
typedef int (*av_make_writable_fn)(void*);
typedef int (*av_opt_set_int_fn)(void*, const char*, int64_t, int);
typedef int (*av_opt_set_fn)(void*, const char*, const char*, int);
typedef const void* (*av_opt_find_fn)(void*, const char*, const char*,
                                      int, int);
typedef int (*av_opt_get_int_fn)(void*, const char*, int, int64_t*);
typedef void (*av_log_set_level_fn)(int);

struct AvLib {
    void* avc = nullptr;            // libavcodec; libavutil through it
    bool tried = false;
    unsigned version = 0;
    av_find_fn find_encoder = nullptr;
    av_find_fn find_decoder = nullptr;
    av_alloc_context_fn alloc_context = nullptr;
    av_free_ptr_fn free_context = nullptr;
    av_open2_fn open2 = nullptr;
    av_send_fn send_frame = nullptr;
    av_receive_fn receive_packet = nullptr;
    av_send_fn send_packet = nullptr;
    av_receive_fn receive_frame = nullptr;
    av_alloc_fn packet_alloc = nullptr;
    av_free_ptr_fn packet_free = nullptr;
    av_unref_fn packet_unref = nullptr;
    av_alloc_fn frame_alloc = nullptr;
    av_free_ptr_fn frame_free = nullptr;
    av_unref_fn frame_unref = nullptr;
    av_make_writable_fn frame_make_writable = nullptr;
    av_opt_set_int_fn opt_set_int = nullptr;
    av_opt_set_fn opt_set = nullptr;
    av_opt_find_fn opt_find = nullptr;
    av_opt_get_int_fn opt_get_int = nullptr;
    std::mutex mu;
};

template <typename T>
static void resolve(void* h, T& fn, const char* name) {
    fn = (T)dlsym(h, name);
}

static AvLib& avlib() {
    static AvLib l;
    std::lock_guard<std::mutex> g(l.mu);
    if (l.tried) return l;
    l.tried = true;
    for (const char* name : {"libavcodec.so.61", "libavcodec.so.60",
                             "libavcodec.so.59", "libavcodec.so.58",
                             "libavcodec.so"}) {
        l.avc = dlopen(name, RTLD_NOW | RTLD_LOCAL);
        if (l.avc) break;
    }
    if (!l.avc) return l;
    // dlsym on libavcodec's handle also searches the libavutil it links
    auto version = (av_version_fn)dlsym(l.avc, "avcodec_version");
    l.version = version ? version() : 0;
    const unsigned major = l.version >> 16;
    resolve(l.avc, l.find_encoder, "avcodec_find_encoder_by_name");
    resolve(l.avc, l.find_decoder, "avcodec_find_decoder_by_name");
    resolve(l.avc, l.alloc_context, "avcodec_alloc_context3");
    resolve(l.avc, l.free_context, "avcodec_free_context");
    resolve(l.avc, l.open2, "avcodec_open2");
    resolve(l.avc, l.send_frame, "avcodec_send_frame");
    resolve(l.avc, l.receive_packet, "avcodec_receive_packet");
    resolve(l.avc, l.send_packet, "avcodec_send_packet");
    resolve(l.avc, l.receive_frame, "avcodec_receive_frame");
    resolve(l.avc, l.packet_alloc, "av_packet_alloc");
    resolve(l.avc, l.packet_free, "av_packet_free");
    resolve(l.avc, l.packet_unref, "av_packet_unref");
    resolve(l.avc, l.frame_alloc, "av_frame_alloc");
    resolve(l.avc, l.frame_free, "av_frame_free");
    resolve(l.avc, l.frame_unref, "av_frame_unref");
    resolve(l.avc, l.frame_make_writable, "av_frame_make_writable");
    resolve(l.avc, l.opt_set_int, "av_opt_set_int");
    resolve(l.avc, l.opt_set, "av_opt_set");
    resolve(l.avc, l.opt_find, "av_opt_find");
    resolve(l.avc, l.opt_get_int, "av_opt_get_int");
    // silence Qavg/experimental chatter on the server's stderr
    auto set_level = (av_log_set_level_fn)dlsym(l.avc, "av_log_set_level");
    if (set_level) set_level(kLogError);
    if (major < 58 || major > 61 || !l.find_encoder || !l.find_decoder ||
        !l.alloc_context || !l.free_context || !l.open2 || !l.send_frame ||
        !l.receive_packet || !l.send_packet || !l.receive_frame ||
        !l.packet_alloc || !l.packet_free || !l.packet_unref ||
        !l.frame_alloc || !l.frame_free || !l.frame_unref ||
        !l.frame_make_writable || !l.opt_set_int || !l.opt_set ||
        !l.opt_find || !l.opt_get_int) {
        dlclose(l.avc);
        l.avc = nullptr;
    }
    return l;
}

BN_API unsigned bn_avcodec_version() { return avlib().version; }

BN_API int bn_aac_available() {
    AvLib& l = avlib();
    return (l.avc && l.find_encoder("aac") && l.find_decoder("aac")) ? 1 : 0;
}

static void write_u32(unsigned char* out, int n) {
    out[0] = (unsigned char)(n & 0xff);
    out[1] = (unsigned char)((n >> 8) & 0xff);
    out[2] = (unsigned char)((n >> 16) & 0xff);
    out[3] = (unsigned char)((n >> 24) & 0xff);
}

static bool emit_packet(const unsigned char* data, int n,
                        unsigned char* out, int64_t out_cap,
                        int64_t& written, int32_t* packets) {
    if (written + 4 + n > out_cap) return false;
    write_u32(out + written, n);
    std::memcpy(out + written + 4, data, (size_t)n);
    written += 4 + n;
    if (packets) (*packets)++;
    return true;
}

// A decoder that reads ADTS: (AOT, frequency index, channels) from an
// AudioSpecificConfig where one is given, else LC at `rate`.
struct AdtsParams {
    int aot = 2;
    int freq_index = -1;
    int channels = 0;
};

static AdtsParams adts_params(const unsigned char* asc, int32_t asc_len,
                              int rate, int channels) {
    AdtsParams p;
    if (asc && asc_len >= 2) {
        p.aot = asc[0] >> 3;
        p.freq_index = ((asc[0] & 0x7) << 1) | (asc[1] >> 7);
        p.channels = (asc[1] >> 3) & 0xF;
    } else {
        p.freq_index = aac_freq_index(rate);
        p.channels = channels;
    }
    // ADTS carries AOT 1 to 4 and a table rate only
    if (p.aot < 1 || p.aot > 4 || p.freq_index < 0 || p.freq_index > 12 ||
        p.channels != channels)
        p.freq_index = -1;
    return p;
}

struct AacDecoder {
    void* ctx;
    void* frame;
    void* pkt;
    int channels;
    AdtsParams adts;
    std::vector<uint8_t> padded;    // ADTS header + AU + input padding
};

static AacDecoder* decoder_open(const AdtsParams& p, int channels) {
    AvLib& l = avlib();
    if (!l.avc || p.freq_index < 0) return nullptr;
    const void* codec = l.find_decoder("aac");
    if (!codec) return nullptr;
    void* ctx = l.alloc_context(codec);
    if (!ctx) return nullptr;
    if (l.open2(ctx, codec, nullptr) < 0) {
        l.free_context(&ctx);
        return nullptr;
    }
    void* frame = l.frame_alloc();
    void* pkt = l.packet_alloc();
    if (!frame || !pkt) {
        if (frame) l.frame_free(&frame);
        if (pkt) l.packet_free(&pkt);
        l.free_context(&ctx);
        return nullptr;
    }
    return new AacDecoder{ctx, frame, pkt, channels, p, {}};
}

static void decoder_close(AacDecoder* d) {
    AvLib& l = avlib();
    l.frame_free(&d->frame);
    l.packet_free(&d->pkt);
    l.free_context(&d->ctx);
    delete d;
}

// Send one access unit (nullptr: drain) in an ADTS frame.
static int decoder_send(AacDecoder* d, const unsigned char* au, int64_t n) {
    AvLib& l = avlib();
    auto* pkt = (AvPacketHead*)d->pkt;
    if (!au) return l.send_packet(d->ctx, nullptr);
    if (n + 7 > 0x1FFF) return -1;           // ADTS's 13-bit frame length
    std::vector<uint8_t> hdr = adts_header(d->adts.aot, d->adts.freq_index,
                                           d->adts.channels, (int)n);
    // the decoder's bitstream reader reads past the payload: zeroed
    // padding after it, as avcodec_send_packet requires
    d->padded.assign(hdr.begin(), hdr.end());
    d->padded.insert(d->padded.end(), au, au + n);
    d->padded.resize(hdr.size() + (size_t)n + kInputPadding, 0);
    pkt->data = d->padded.data();
    pkt->size = (int)(hdr.size() + (size_t)n);
    return l.send_packet(d->ctx, d->pkt);
}

// Receive every frame the decoder holds into interleaved int16 `out` at
// `frames`. Returns the frames added, -3 when out is full, -4 on error.
static int64_t decoder_receive(AacDecoder* d, int16_t* out, int64_t frames,
                               int64_t out_cap_frames) {
    AvLib& l = avlib();
    int64_t added = 0;
    for (;;) {
        int r = l.receive_frame(d->ctx, d->frame);
        if (r == kErrorEagain || r == kErrorEof) break;
        if (r < 0) return -4;
        auto* f = (AvFrameHead*)d->frame;
        const int got = f->nb_samples;
        if (f->format != kSampleFmtFltp) {
            l.frame_unref(d->frame);
            return -4;
        }
        if (frames + added + got > out_cap_frames) {
            l.frame_unref(d->frame);
            return -3;
        }
        for (int c = 0; c < d->channels; ++c) {
            const float* srcf = (const float*)f->data[c];
            for (int i = 0; i < got; ++i) {
                float v = srcf[i];
                if (v > 0.999969f) v = 0.999969f;
                if (v < -1.0f) v = -1.0f;
                out[(frames + added + i) * d->channels + c] =
                    (int16_t)(v * 32768.0f);
            }
        }
        added += got;
        l.frame_unref(d->frame);
    }
    return added;
}

struct AacStream {
    void* ctx;
    void* frame;                    // a decoded frame: layout set by libav
    void* pkt;
    int rate;
    int channels;
    int frame_size;
    std::vector<int16_t> carry;     // < one 1024-sample frame, interleaved
    // a packet that did not fit the caller's out buffer is PARKED here
    // (never destroyed — once pulled from the encoder it cannot be
    // re-received) and emitted first on the next drain
    std::vector<unsigned char> pending;
    bool flushed = false;
};

// Drain every pending packet from the encoder into the length-prefixed
// out buffer. A packet that doesn't fit is parked on the stream (NOT
// destroyed) and the bytes already written are returned — no audio is
// ever lost to an undersized buffer. Returns bytes appended or -4.
static int64_t aac_drain(AacStream* s, unsigned char* out, int64_t out_cap,
                         int64_t written, int32_t* packets) {
    AvLib& l = avlib();
    if (!s->pending.empty()) {
        if (!emit_packet(s->pending.data(), (int)s->pending.size(), out,
                         out_cap, written, packets)) {
            return written;
        }
        s->pending.clear();
    }
    for (;;) {
        int r = l.receive_packet(s->ctx, s->pkt);
        if (r == kErrorEagain || r == kErrorEof) return written;
        if (r < 0) return -4;
        auto* p = (AvPacketHead*)s->pkt;
        int n = p->size;
        if (!emit_packet(p->data, n, out, out_cap, written, packets)) {
            s->pending.assign(p->data, p->data + n);
            l.packet_unref(s->pkt);
            return written;
        }
        l.packet_unref(s->pkt);
    }
}

static int set_channels(AvLib& l, void* ctx, int channels) {
    if (l.opt_set(ctx, "ch_layout", channels == 1 ? "mono" : "stereo",
                  0) >= 0)
        return 0;
    // before libavcodec 59.24: the count and the mask (AV_CH_LAYOUT_*)
    if (l.opt_set_int(ctx, "ac", channels, 0) < 0) return -1;
    return l.opt_set_int(ctx, "channel_layout", channels == 1 ? 0x4 : 0x3,
                         0);
}

// AVCodecContext has no AVOption for sample_fmt. From libavcodec 58 to 61
// the field lies just before frame_size, after sample_rate (with the
// deprecated channels between them before 61): its place comes from the
// "frame_size" and "ar" options' offsets, and is written only where
// those are 8 or 12 bytes apart and a fresh context holds
// AV_SAMPLE_FMT_NONE (-1) there.
static int set_sample_fmt_fltp(AvLib& l, void* ctx) {
    auto* fs = (const AvOptionHead*)l.opt_find(ctx, "frame_size", nullptr,
                                               0, 0);
    auto* ar = (const AvOptionHead*)l.opt_find(ctx, "ar", nullptr, 0, 0);
    if (!fs || !ar) return -1;
    const int gap = fs->offset - ar->offset;
    if (gap != 8 && gap != 12) return -1;
    int* fmt = (int*)((char*)ctx + fs->offset - (int)sizeof(int));
    if (*fmt != -1) return -1;
    *fmt = kSampleFmtFltp;
    return 0;
}

// The stream's input frame: one silent ADTS frame decoded at `rate` and
// `channels`, which libavcodec lays out as the encoder wants (FLTP,
// frame_size samples, the channel layout) without a header here.
static void* template_frame(int freq_index, int channels, int frame_size) {
    AvLib& l = avlib();
    AdtsParams p;
    p.freq_index = freq_index;
    p.channels = channels;
    AacDecoder* d = decoder_open(p, channels);
    if (!d) return nullptr;
    std::vector<uint8_t> au = silent_block(channels);
    void* frame = nullptr;
    if (decoder_send(d, au.data(), (int64_t)au.size()) >= 0 &&
        l.receive_frame(d->ctx, d->frame) >= 0) {
        auto* f = (AvFrameHead*)d->frame;
        const bool planes = channels == 2 ? f->data[1] != nullptr
                                          : f->data[1] == nullptr;
        if (f->nb_samples == frame_size && f->format == kSampleFmtFltp &&
            f->data[0] && planes) {
            frame = d->frame;
            d->frame = l.frame_alloc();
        }
    }
    decoder_close(d);
    return frame;
}

// Create a streaming AAC-LC encoder. asc_out receives the
// AudioSpecificConfig (the esds/mp4a DecoderSpecificInfo); returns the
// handle or null.
BN_API void* bn_aac_stream_create(int rate, int channels, int bitrate,
                                  unsigned char* asc_out, int32_t asc_cap,
                                  int32_t* asc_len) {
    AvLib& l = avlib();
    const int fi = aac_freq_index(rate);
    if (!l.avc || channels < 1 || channels > 2 || fi < 0) return nullptr;
    const void* codec = l.find_encoder("aac");
    if (!codec) return nullptr;
    void* ctx = l.alloc_context(codec);
    if (!ctx) return nullptr;
    int64_t fsz = 0;
    if (l.opt_set_int(ctx, "ar", rate, 0) < 0 ||
        set_sample_fmt_fltp(l, ctx) < 0 ||
        l.opt_set_int(ctx, "b", bitrate, 0) < 0 ||
        l.opt_set_int(ctx, "profile", kProfileAacLow, 0) < 0 ||
        l.opt_set(ctx, "flags", "+global_header", 0) < 0 ||
        set_channels(l, ctx, channels) < 0 ||
        l.open2(ctx, codec, nullptr) < 0 ||
        l.opt_get_int(ctx, "frame_size", 0, &fsz) < 0 || fsz != kAacFrame) {
        l.free_context(&ctx);
        return nullptr;
    }
    void* frame = template_frame(fi, channels, (int)fsz);
    void* pkt = l.packet_alloc();
    if (!frame || !pkt) {
        if (frame) l.frame_free(&frame);
        if (pkt) l.packet_free(&pkt);
        l.free_context(&ctx);
        return nullptr;
    }
    if (asc_len) {
        // FFmpeg's put_audio_specific_config: AOT 2, the rate index, the
        // channel configuration, GASpecificConfig 000, then the sync
        // extension 0x2b7, AOT_SBR (5) and sbrPresentFlag 0
        BitWriter w;
        w.put(2, 5);
        w.put((uint32_t)fi, 4);
        w.put((uint32_t)channels, 4);
        w.put(0, 3);
        w.put(0x2b7, 11);
        w.put(5, 5);
        w.put(0, 1);
        const int32_t n = (int32_t)w.out.size();
        if (asc_out && n <= asc_cap)
            std::memcpy(asc_out, w.out.data(), (size_t)n);
        *asc_len = n;
    }
    return new AacStream{ctx, frame, pkt, rate, channels, (int)fsz,
                         {}, {}, false};
}

// Feed interleaved int16 PCM; writes length-prefixed raw AAC packets
// (1024 samples per packet). Returns bytes written or negative error
// (-1 bad handle, -3 out full, -4 encoder error).
BN_API int64_t bn_aac_stream_encode(void* handle, const int16_t* pcm,
                                    int64_t n_frames, unsigned char* out,
                                    int64_t out_cap, int32_t* n_packets) {
    AvLib& l = avlib();
    auto* s = (AacStream*)handle;
    if (!s || !l.avc || s->flushed) return -1;
    if (n_frames < 0) return -2;
    if (n_packets) *n_packets = 0;
    const int fsz = s->frame_size;
    if (pcm && n_frames > 0)
        s->carry.insert(s->carry.end(), pcm,
                        pcm + (size_t)n_frames * s->channels);
    int64_t written = 0;
    size_t off = 0;
    const size_t frame_sz = (size_t)fsz * s->channels;
    while (s->carry.size() - off >= frame_sz) {
        // the encoder keeps a reference to the frame it was sent: a new
        // buffer when it still holds this one
        if (l.frame_make_writable(s->frame) < 0) return -4;
        auto* f = (AvFrameHead*)s->frame;
        const int16_t* src = s->carry.data() + off;
        for (int c = 0; c < s->channels; ++c) {
            float* dst = (float*)f->data[c];
            for (int i = 0; i < fsz; ++i)
                dst[i] = src[(size_t)i * s->channels + c] * (1.0f / 32768.0f);
        }
        int r = l.send_frame(s->ctx, s->frame);
        if (r < 0) return -4;
        off += frame_sz;
        written = aac_drain(s, out, out_cap, written, n_packets);
        if (written < 0) break;
    }
    s->carry.erase(s->carry.begin(), s->carry.begin() + (long)off);
    return written;
}

// Pad the final partial frame with silence, flush the encoder, and emit
// the remaining packets. The stream is unusable afterwards.
BN_API int64_t bn_aac_stream_flush(void* handle, unsigned char* out,
                                   int64_t out_cap, int32_t* n_packets) {
    AvLib& l = avlib();
    auto* s = (AacStream*)handle;
    if (!s || !l.avc) return -1;
    if (s->flushed) {
        // re-entry drains only a parked packet (encoder is at EOF)
        if (n_packets) *n_packets = 0;
        return aac_drain(s, out, out_cap, 0, n_packets);
    }
    if (n_packets) *n_packets = 0;
    int64_t written = 0;
    if (!s->carry.empty()) {
        const size_t frame_sz = (size_t)s->frame_size * s->channels;
        s->carry.resize(frame_sz, 0);
        written = bn_aac_stream_encode(handle, nullptr, 0, out, out_cap,
                                       n_packets);
        if (written < 0) return written;
    }
    s->flushed = true;
    if (l.send_frame(s->ctx, nullptr) < 0) return -4;
    int32_t extra = 0;
    int64_t total = aac_drain(s, out, out_cap, written, &extra);
    if (n_packets && total >= 0) *n_packets += extra;
    return total;
}

// Encoder priming delay in samples (MP4 edit lists trim it): the 1024 of
// FFmpeg's native AAC encoder.
BN_API int32_t bn_aac_stream_delay(void* handle) {
    return handle ? kAacPriming : 0;
}

BN_API void bn_aac_stream_destroy(void* handle) {
    AvLib& l = avlib();
    auto* s = (AacStream*)handle;
    if (!s) return;
    l.frame_free(&s->frame);
    l.packet_free(&s->pkt);
    l.free_context(&s->ctx);
    delete s;
}

// Decode length-prefixed raw AAC packets of the stream the ASC describes
// (or LC at `rate`) back to interleaved int16 PCM — the e2e oracle for
// encoder and mux tests, mirroring bn_opus_decode. Returns frames per
// channel written, or negative error.
BN_API int64_t bn_aac_decode(const unsigned char* packets,
                             int64_t packets_len, const unsigned char* asc,
                             int32_t asc_len, int rate, int channels,
                             int16_t* out, int64_t out_cap_frames) {
    AvLib& l = avlib();
    if (!l.avc) return -1;
    if (!packets || channels < 1 || channels > 2) return -2;
    AdtsParams p = adts_params(asc, asc_len, rate, channels);
    if (p.freq_index < 0) return -2;
    AacDecoder* d = decoder_open(p, channels);
    if (!d) return -4;
    int64_t frames = 0;
    int64_t off = 0;
    bool fail = false;
    while (off + 4 <= packets_len && !fail) {
        uint32_t n = (uint32_t)packets[off] | ((uint32_t)packets[off + 1] << 8)
            | ((uint32_t)packets[off + 2] << 16)
            | ((uint32_t)packets[off + 3] << 24);
        off += 4;
        if (off + (int64_t)n > packets_len) break;
        if (decoder_send(d, packets + off, n) < 0) { fail = true; break; }
        off += n;
        int64_t got = decoder_receive(d, out, frames, out_cap_frames);
        if (got < 0) { fail = true; break; }
        frames += got;
    }
    // drain decoder
    if (!fail && decoder_send(d, nullptr, 0) >= 0) {
        int64_t got = decoder_receive(d, out, frames, out_cap_frames);
        if (got > 0) frames += got;
    }
    decoder_close(d);
    return fail && frames == 0 ? -4 : frames;
}

// Persistent AAC decoder handle for RTP streams (RFC 3640 AUs arrive one
// packet at a time; AAC-LC's MDCT overlap-add means frames must decode
// through ONE decoder instance or every frame boundary clicks).
BN_API void* bn_aac_decoder_create(const unsigned char* asc,
                                   int32_t asc_len, int rate,
                                   int channels) {
    if (channels < 1 || channels > 2) return nullptr;
    return decoder_open(adts_params(asc, asc_len, rate, channels), channels);
}

// Decode ONE access unit; returns frames per channel written to out
// (interleaved int16), 0 when the decoder buffered it, negative error.
BN_API int64_t bn_aac_decoder_decode(void* handle, const unsigned char* au,
                                     int64_t au_len, int16_t* out,
                                     int64_t out_cap_frames) {
    auto* d = (AacDecoder*)handle;
    if (!d || !avlib().avc || !au || au_len <= 0) return -1;
    if (decoder_send(d, au, au_len) < 0) return -4;
    return decoder_receive(d, out, 0, out_cap_frames);
}

BN_API void bn_aac_decoder_destroy(void* handle) {
    auto* d = (AacDecoder*)handle;
    if (d) decoder_close(d);
}
